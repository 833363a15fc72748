"""Self-consistency tests for the host oracle (ground truth for everything).

Mirrors the reference's correctness bar (SURVEY.md §4): NTT round-trip
exactness, convolution property, RNS/CRT round trips, and end-to-end
decrypt(ops(encrypt(m))) == expected slot values from the reference tests
(tests/test_fhe.cu:264,270; examples/homomorphic_operations.cu:92-242)."""

import random

import pytest

from fhe_jax import oracle, primes
from fhe_jax.params import SecurityParams, make_scheme_params


def small_params(n=64, log_q=60):
    return make_scheme_params(
        SecurityParams(poly_degree=n, log_q=log_q, hamming_weight=min(64, n // 2))
    )


def test_prime_generation():
    n = 4096
    ps = primes.find_ntt_primes(n, 9)
    assert len(set(ps)) == 9
    for p in ps:
        assert primes.is_prime(p)
        assert p % (2 * n) == 1
        assert (1 << 29) < p < (1 << 30)


def test_roots():
    p = primes.find_ntt_primes(256, 1)[0]
    psi = primes.negacyclic_psi(256, p)
    assert pow(psi, 256, p) == p - 1
    assert pow(psi, 512, p) == 1


@pytest.mark.parametrize("n", [8, 64, 256])
def test_ntt_roundtrip(n):
    p = primes.find_ntt_primes(n, 1)[0]
    tb = oracle.build_ntt_tables(n, p)
    rng = random.Random(1)
    a = [rng.randrange(p) for _ in range(n)]
    assert oracle.ntt_inverse(oracle.ntt_forward(a, tb), tb) == a


@pytest.mark.parametrize("n", [8, 64, 256])
def test_ntt_convolution_matches_schoolbook(n):
    p = primes.find_ntt_primes(n, 1)[0]
    tb = oracle.build_ntt_tables(n, p)
    rng = random.Random(2)
    a = [rng.randrange(p) for _ in range(n)]
    b = [rng.randrange(p) for _ in range(n)]
    fa = oracle.ntt_forward(a, tb)
    fb = oracle.ntt_forward(b, tb)
    pw = [x * y % p for x, y in zip(fa, fb)]
    got = oracle.ntt_inverse(pw, tb)
    want = oracle.negacyclic_mul_mod(a, b, p)
    assert got == want


def test_ntt_output_ordering():
    """output[i] == a(psi^(2*brv(i)+1)) — the ordering BatchEncoder relies on."""
    n = 16
    p = primes.find_ntt_primes(n, 1)[0]
    tb = oracle.build_ntt_tables(n, p)
    rng = random.Random(3)
    a = [rng.randrange(p) for _ in range(n)]
    f = oracle.ntt_forward(a, tb)
    bits = n.bit_length() - 1
    for i in range(n):
        e = 2 * primes.bit_reverse(i, bits) + 1
        x = pow(tb.psi, e, p)
        want = sum(c * pow(x, j, p) for j, c in enumerate(a)) % p
        assert f[i] == want, i


def test_kronecker_negacyclic():
    n = 8
    q = 97
    a = [3, 1, 4, 1, 5, 9, 2, 6]
    b = [2, 7, 1, 8, 2, 8, 1, 8]
    got = oracle.negacyclic_mul_mod(a, b, q)
    # schoolbook negacyclic
    want = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                want[k] = (want[k] + a[i] * b[j]) % q
            else:
                want[k - n] = (want[k - n] - a[i] * b[j]) % q
    assert got == want


def test_rns_roundtrip_and_base_conv():
    basis = oracle.RNSBasis(tuple(primes.find_ntt_primes(64, 3)))
    rng = random.Random(4)
    x = [rng.randrange(basis.Q) for _ in range(16)]
    res = oracle.to_rns(x, basis)
    assert oracle.from_rns(res, basis) == x
    # fast base conversion = x + alpha*Q in target primes, alpha in [0, k)
    target = tuple(primes.find_ntt_primes(64, 2, exclude=basis.primes))
    conv = oracle.fast_base_conv(res, basis, target)
    for ci, c in enumerate(target):
        for j in range(16):
            diffs = [(x[j] + alpha * basis.Q) % c for alpha in range(3)]
            assert conv[ci][j] in diffs


def test_sm_mrq_exact_conversion():
    basis = oracle.RNSBasis(tuple(primes.find_ntt_primes(64, 3)))
    target = tuple(primes.find_ntt_primes(64, 3, exclude=basis.primes))
    rng = random.Random(5)
    x = [rng.randrange(basis.Q) for _ in range(16)]
    res = oracle.to_rns(x, basis)
    out = oracle.sm_mrq(res, basis, 1 << 16, target)
    # Output is the centered lift: exactly x or x - Q per coefficient,
    # consistently across all target primes.
    for j in range(16):
        for lift in (x[j], x[j] - basis.Q):
            if all(out[ci][j] == lift % c for ci, c in enumerate(target)):
                break
        else:
            raise AssertionError(f"coefficient {j} is neither x nor x-Q")


def test_fast_floor():
    params = small_params()
    basis = oracle.RNSBasis(params.q_primes)
    bsk = params.bsk_primes
    rng = random.Random(6)
    t = params.t
    # x up to n * q^2 like a real tensor product coefficient
    xs = [rng.randrange(params.n * params.q**2) for _ in range(8)]
    tx = [t * x for x in xs]
    tx_q = [[v % p for v in tx] for p in basis.primes]
    tx_bsk = [[v % p for v in tx] for p in bsk]
    out = oracle.fast_floor(tx_q, tx_bsk, basis, bsk)
    k = len(basis.primes)
    for ci, c in enumerate(bsk):
        for j, x in enumerate(xs):
            floor_val = t * x // params.q
            ok = any(out[ci][j] == (floor_val - alpha) % c for alpha in range(k))
            assert ok


def test_fast_bconv_sk():
    params = small_params()
    aux = params.aux_primes
    m_sk = params.m_sk
    B = 1
    for b in aux:
        B *= b
    rng = random.Random(7)
    xs = [rng.randrange(B // 4) for _ in range(8)]  # well inside range
    x_bsk = [[x % p for x in xs] for p in aux] + [[x % m_sk for x in xs]]
    out = oracle.fast_bconv_sk(x_bsk, aux, m_sk, params.q_primes)
    for ci, c in enumerate(params.q_primes):
        assert out[ci] == [x % c for x in xs]


def test_decrypt_scale_gamma_matches_round_div():
    params = small_params()
    basis = oracle.RNSBasis(params.q_primes)
    q, t = params.q, params.t
    rng = random.Random(8)
    # x = Delta*m + small noise (valid ciphertext phase)
    xs = []
    for _ in range(32):
        m = rng.randrange(t)
        v = rng.randrange(-(q // (4 * t)), q // (4 * t))
        xs.append((params.delta * m + v) % q)
    res = [[x % p for x in xs] for p in basis.primes]
    got = oracle.decrypt_scale_gamma(res, basis, t, params.gamma)
    want = [oracle.round_div(t * x, q) % t for x in xs]
    assert got == want


def test_mod_switch_drop_last():
    ps = tuple(primes.find_ntt_primes(64, 3))
    Q = ps[0] * ps[1] * ps[2]
    rng = random.Random(9)
    xs = [rng.randrange(Q) for _ in range(16)]
    res = [[x % p for x in xs] for p in ps]
    out = oracle.mod_switch_drop_last(res, ps)
    for ci, c in enumerate(ps[:-1]):
        for j, x in enumerate(xs):
            want = oracle.round_div(x, ps[-1]) % c
            assert out[ci][j] == want


def test_bfv_end_to_end_add_mul():
    params = small_params(n=64, log_q=60)
    orc = oracle.BFVOracle(params, seed=42)
    pk, sk = orc.keygen()
    rlk = orc.relin_keygen(sk)
    m1 = [5, 10, 15, 20] + [0] * (params.n - 4)
    m2 = [3, 6, 9, 12] + [0] * (params.n - 4)
    ct1 = orc.encrypt(pk, m1)
    ct2 = orc.encrypt(pk, m2)
    # decrypt round trip
    assert orc.decrypt(ct1, sk)[:4] == [5, 10, 15, 20]
    # homomorphic add (reference expected vector tests/test_fhe.cu:264)
    ct_add = orc.add(ct1, ct2)
    assert orc.decrypt(ct_add, sk)[:4] == [8, 16, 24, 32]
    # multiply + relinearize: coefficient encoding gives negacyclic conv
    ct_mul = orc.multiply(ct1, ct2, rlk)
    dec = orc.decrypt(ct_mul, sk)
    want = oracle.negacyclic_mul_mod(m1, m2, params.t)
    assert dec == want


def test_slot_encoding_simd_semantics():
    """Slot encoding makes multiply act slot-wise — the semantics the
    reference tests assume (expected 15 60 135 240, tests/test_fhe.cu:270)."""
    params = small_params(n=64, log_q=60)
    n, t = params.n, params.t
    tb = oracle.build_ntt_tables(n, t)
    vals1 = [5, 10, 15, 20]
    vals2 = [3, 6, 9, 12]
    pt1 = oracle.slot_encode(vals1, n, t, tb)
    pt2 = oracle.slot_encode(vals2, n, t, tb)
    assert oracle.slot_decode(pt1, n, t, tb)[:4] == vals1
    # slot-wise product under negacyclic poly multiplication
    prod = oracle.negacyclic_mul_mod(pt1, pt2, t)
    assert oracle.slot_decode(prod, n, t, tb)[:4] == [15, 60, 135, 240]
    # slot-wise add
    s = [(a + b) % t for a, b in zip(pt1, pt2)]
    assert oracle.slot_decode(s, n, t, tb)[:4] == [8, 16, 24, 32]


def test_slot_encoding_rotation_structure():
    """Galois automorphism x -> x^3 rotates row slots by one position."""
    params = small_params(n=64, log_q=60)
    n, t = params.n, params.t
    tb = oracle.build_ntt_tables(n, t)
    half = n // 2
    vals = list(range(1, n + 1))
    pt = oracle.slot_encode(vals, n, t, tb)
    # sigma_3: a(x) -> a(x^3) in coefficient domain with negacyclic wrap
    g = 3
    out = [0] * n
    for i, c in enumerate(pt):
        e = g * i
        pos = e % n
        sign = (e // n) % 2
        out[pos] = (out[pos] + (-c if sign else c)) % t
    rotated = oracle.slot_decode(out, n, t, tb)
    # row 0 rotates left by 1: slot j <- slot j+1 (cyclically within the row)
    row0 = vals[:half]
    row1 = vals[half:]
    expect_row0 = row0[1:] + row0[:1]
    expect_row1 = row1[1:] + row1[:1]
    assert rotated[:half] == expect_row0
    assert rotated[half:] == expect_row1


def test_behz_multiply_matches_textbook_semantics():
    """BEHZ RNS multiply must decrypt to the same plaintext product as the
    exact textbook multiply (noise differs slightly, result must not)."""
    params = small_params(n=64, log_q=60)
    orc = oracle.BFVOracle(params, seed=11)
    pk, sk = orc.keygen()
    rlk = orc.relin_keygen(sk)
    m1 = [3, 4, 5, 6] + [0] * (params.n - 4)
    m2 = [2, 5, 10, 3] + [0] * (params.n - 4)
    ct1 = orc.encrypt(pk, m1)
    ct2 = orc.encrypt(pk, m2)
    ct3 = oracle.behz_multiply_no_relin(params, ct1, ct2)
    ct_mul = orc.relinearize(ct3, rlk)
    want = oracle.negacyclic_mul_mod(m1, m2, params.t)
    assert orc.decrypt(ct_mul, sk) == want


def test_bgv_oracle_mod_switch_decrypt():
    """BGVOracle.decrypt(q=...) must decrypt the output of its own
    mod_switch_drop_last (review finding: it used to reduce mod full q)."""
    from fhe_jax.params import SecurityParams, make_scheme_params

    params = make_scheme_params(
        SecurityParams(poly_degree=64, log_q=120, hamming_weight=8))
    o = oracle.BGVOracle(params, seed=6)
    pk, s = o.keygen()
    m = [7, 11, 13] + [0] * 61
    ct = o.encrypt(pk, m)
    ct2 = o.mod_switch_drop_last(ct)
    q_last = params.q_primes[-1]
    got = o.decrypt(ct2, s, scale_t=q_last % params.t,
                    q=params.q // q_last)
    assert got == [c % params.t for c in m]
