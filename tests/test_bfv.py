"""End-to-end BFV scheme tests — the reference's correctness bar plus
bit-exact multiply vs the oracle BEHZ pipeline.

Reference expectations covered (SURVEY.md §4):
  * decrypt(encrypt(m)) round trip              (examples/basic_encryption.cu:91-106)
  * add -> 8 16 24 32                           (tests/test_fhe.cu:264)
  * multiply+relin -> 15 60 135 240 (slot-wise) (tests/test_fhe.cu:270)
  * chained (a+b)*c, plain ops                  (examples/homomorphic_operations.cu)
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_jax import FHE, oracle
from fhe_jax.params import SecurityParams, make_scheme_params
from fhe_jax.scheme import bfv
from fhe_jax.ops import rns as _rns

PARAMS = make_scheme_params(
    SecurityParams(poly_degree=256, log_q=120, hamming_weight=32))


@pytest.fixture(scope="module")
def fhe():
    return FHE(PARAMS, seed=3)


@pytest.fixture(scope="module")
def keys(fhe):
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    return pk, sk, rlk


def test_encrypt_decrypt_roundtrip(fhe, keys):
    pk, sk, _ = keys
    vals = [5, 10, 15, 20]
    ct = fhe.encrypt(fhe.encode(vals), pk)
    got = fhe.decode(fhe.decrypt(ct, sk))
    assert list(got[:4]) == vals
    assert all(v == 0 for v in got[4:])


def test_homomorphic_add(fhe, keys):
    pk, sk, _ = keys
    ct1 = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    ct2 = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    got = fhe.decode(fhe.decrypt(fhe.add(ct1, ct2), sk))
    assert list(got[:4]) == [8, 16, 24, 32]  # reference tests/test_fhe.cu:264


def test_homomorphic_sub(fhe, keys):
    pk, sk, _ = keys
    ct1 = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    ct2 = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    got = fhe.decode(fhe.decrypt(fhe.sub(ct1, ct2), sk))
    assert list(got[:4]) == [2, 4, 6, 8]


def test_homomorphic_multiply_slotwise(fhe, keys):
    pk, sk, rlk = keys
    ct1 = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    ct2 = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    got = fhe.decode(fhe.decrypt(fhe.multiply(ct1, ct2, rlk), sk))
    assert list(got[:4]) == [15, 60, 135, 240]  # reference tests/test_fhe.cu:270


def test_multiply_bit_exact_vs_oracle_behz(fhe, keys):
    """Device multiply_no_relin output must equal the oracle BEHZ pipeline
    exactly (same bases, same floors)."""
    pk, sk, _ = keys
    ct1 = fhe.encrypt(fhe.encode([7, 1, 2, 3]), pk)
    ct2 = fhe.encrypt(fhe.encode([4, 5, 6, 9]), pk)
    ct3 = fhe.multiply_no_relin(ct1, ct2)
    # reconstruct device inputs as big ints and run the oracle pipeline
    def ct_to_bigint(ct):
        return [
            _rns.from_rns_host(np.asarray(ct.data)[:, c, :], PARAMS.q_primes)
            for c in range(ct.data.shape[1])
        ]
    want = oracle.behz_multiply_no_relin(PARAMS, ct_to_bigint(ct1), ct_to_bigint(ct2))
    got = ct_to_bigint(ct3)
    assert got == want


def test_chained_ops(fhe, keys):
    """(a + b) * c — reference examples/homomorphic_operations.cu:180-205."""
    pk, sk, rlk = keys
    ct_a = fhe.encrypt(fhe.encode([10, 20, 30, 40]), pk)
    ct_b = fhe.encrypt(fhe.encode([5, 15, 25, 35]), pk)
    ct_c = fhe.encrypt(fhe.encode([3, 4, 5, 6]), pk)
    out = fhe.multiply(fhe.add(ct_a, ct_b), ct_c, rlk)
    got = fhe.decode(fhe.decrypt(out, sk))
    assert list(got[:4]) == [45, 140, 275, 450]


def test_plain_ops(fhe, keys):
    """ct + pt and ct * pt — reference examples/homomorphic_operations.cu:208-242."""
    pk, sk, _ = keys
    ct = fhe.encrypt(fhe.encode([10, 20, 30, 40]), pk)
    pt2 = fhe.encode([2, 2, 2, 2])
    got_add = fhe.decode(fhe.decrypt(fhe.add_plain(ct, pt2), sk))
    assert list(got_add[:4]) == [12, 22, 32, 42]
    got_sub = fhe.decode(fhe.decrypt(fhe.sub_plain(ct, pt2), sk))
    assert list(got_sub[:4]) == [8, 18, 28, 38]
    got_mul = fhe.decode(fhe.decrypt(fhe.multiply_plain(ct, pt2), sk))
    assert list(got_mul[:4]) == [20, 40, 60, 80]


def test_noise_budget_tracking(fhe, keys):
    pk, sk, rlk = keys
    ct = fhe.encrypt(fhe.encode([1, 2, 3]), pk)
    fresh = fhe.estimate_noise_budget(ct, sk)
    assert fresh > 40, f"fresh budget too small: {fresh}"
    ct2 = fhe.multiply(ct, ct, rlk)
    after = fhe.estimate_noise_budget(ct2, sk)
    assert 0 < after < fresh
    # bookkeeping field moves the same direction
    assert ct2.noise_budget < ct.noise_budget


def test_mod_switch_then_decrypt(fhe, keys):
    pk, sk, _ = keys
    ct = fhe.encrypt(fhe.encode([9, 8, 7, 6]), pk)
    ct_l1 = fhe.mod_switch_to_next(ct)
    assert ct_l1.level == 1
    got = fhe.decode(fhe.decrypt(ct_l1, sk))
    assert list(got[:4]) == [9, 8, 7, 6]
    ct_l2 = fhe.mod_switch_to_next(ct_l1)
    got2 = fhe.decode(fhe.decrypt(ct_l2, sk))
    assert list(got2[:4]) == [9, 8, 7, 6]


def test_rotations(fhe, keys):
    pk, sk, _ = keys
    gal = fhe.galoiskey_gen(sk)
    half = PARAMS.slot_count
    vals = list(range(1, half + 1)) + list(range(1001, 1001 + half))
    ct = fhe.encrypt(fhe.encode(vals), pk)
    # rotate rows left by 1
    got = fhe.decode(fhe.decrypt(fhe.rotate_rows(ct, 1, gal), sk))
    row0 = vals[:half]
    row1 = vals[half:]
    assert list(got[:half]) == row0[1:] + row0[:1]
    assert list(got[half:]) == row1[1:] + row1[:1]
    # rotate by 3 (decomposes into steps 1+2)
    got3 = fhe.decode(fhe.decrypt(fhe.rotate_rows(ct, 3, gal), sk))
    assert list(got3[:half]) == row0[3:] + row0[:3]
    # column swap
    gotc = fhe.decode(fhe.decrypt(fhe.rotate_columns(ct, gal), sk))
    assert list(gotc[:half]) == row1
    assert list(gotc[half:]) == row0


def test_bootstrap_refreshes_noise(fhe, keys):
    pk, sk, rlk = keys
    ct = fhe.encrypt(fhe.encode([11, 22]), pk)
    ct = fhe.multiply(ct, ct, rlk)
    before = fhe.estimate_noise_budget(ct, sk)
    ct_fresh = fhe.bootstrap(ct, sk, pk)
    after = fhe.estimate_noise_budget(ct_fresh, sk)
    assert after > before
    got = fhe.decode(fhe.decrypt(ct_fresh, sk))
    assert list(got[:2]) == [121, 484]


def test_coeff_encoding_gives_convolution(fhe, keys):
    """encode_coeff multiplies as negacyclic convolution (reference's actual
    coefficient encode, src/fhe.cu:113-136)."""
    pk, sk, rlk = keys
    m1 = [5, 10, 15, 20]
    m2 = [3, 6, 9, 12]
    ct1 = fhe.encrypt(fhe.encode_coeff(m1), pk)
    ct2 = fhe.encrypt(fhe.encode_coeff(m2), pk)
    got = fhe.decode_coeff(fhe.decrypt(fhe.multiply(ct1, ct2, rlk), sk))
    n, t = PARAMS.n, PARAMS.t
    want = oracle.negacyclic_mul_mod(m1 + [0] * (n - 4), m2 + [0] * (n - 4), t)
    assert list(got) == want


def test_multiply_rejects_three_components(fhe, keys):
    """A 3-component (unrelinearized) operand must be rejected loudly, not
    silently mis-sliced by the batched-NTT concat."""
    pk, _, _ = keys
    ct = fhe.encrypt(fhe.encode([1, 2]), pk)
    ct3 = fhe.multiply_no_relin(ct, ct)
    assert ct3.num_components == 3
    with pytest.raises(ValueError):
        fhe.multiply_no_relin(ct3, ct)


def test_encode_negative_values(fhe, keys):
    """Signed plaintexts: -1 must encode as t-1, not wrap through uint64
    (review finding: 2^64 = 1 mod 65537 made -1 encode as 0)."""
    import numpy as np
    pk, sk, _ = keys
    t = PARAMS.t
    for vals in ([-1, -2, 5], np.array([-1, -2, 5], dtype=np.int64)):
        ct = fhe.encrypt(fhe.encode(vals), pk)
        got = fhe.decode(fhe.decrypt(ct, sk))
        assert list(got[:3]) == [t - 1, t - 2, 5]


def test_hoisted_rotations_match_sequential(fhe, keys):
    """apply_galois_hoisted shares one gadget decomposition across many
    automorphisms; its outputs decrypt identically to per-rotation
    apply_galois.  (Not bit-identical: on sign-flipped coefficients the
    hoisted digits are the -d representatives rather than q_j - d — both
    valid gadget decompositions of the same automorphism.)"""
    from fhe_jax.scheme import bfv as _bfv

    pk, sk, rlk = keys
    m = 2 * fhe.params.n
    elements = [pow(3, 1, m), pow(3, 2, m), m - 1]
    gk = fhe.galoiskey_gen(sk, elements=elements)
    ct = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    hoisted = _bfv.apply_galois_hoisted(fhe.ctx, ct, elements, gk)
    for g, got in zip(elements, hoisted):
        want = _bfv.apply_galois(fhe.ctx, ct, g, gk)
        np.testing.assert_array_equal(
            np.asarray(fhe.decrypt(got, sk).data),
            np.asarray(fhe.decrypt(want, sk).data))
        assert fhe.estimate_noise_budget(got, sk) > 10.0
    # API surface: rotations by steps with direct keys
    outs = fhe.rotate_rows_hoisted(ct, [1, 2], gk)
    r1 = fhe.decode(fhe.decrypt(outs[0], sk))
    r2 = fhe.decode(fhe.decrypt(outs[1], sk))
    assert list(r1[:3]) == [10, 15, 20]
    assert list(r2[:2]) == [15, 20]


def test_hoisted_rotation_multi_ct(fhe, keys):
    """rotate_rows_hoisted_batch: C independent ciphertexts x E steps in one
    hoisted sweep; outs[c][e] decrypts like rotate_rows(cts[c], steps[e])."""
    pk, sk, _ = keys
    m = 2 * fhe.params.n
    steps = [1, 2]
    gk = fhe.galoiskey_gen(sk, elements=[pow(3, s, m) for s in steps])
    base = [[10 * c + j for j in range(1, 7)] for c in range(3)]
    cts = [fhe.encrypt(fhe.encode(v), pk) for v in base]
    outs = fhe.rotate_rows_hoisted_batch(cts, steps, gk)
    assert len(outs) == 3 and all(len(o) == 2 for o in outs)
    for c in range(3):
        for s, out in zip(steps, outs[c]):
            got = fhe.decode(fhe.decrypt(out, sk))
            assert list(got[:3]) == base[c][s:s + 3], (c, s)
            assert fhe.estimate_noise_budget(out, sk) > 10.0


def test_hoisted_rotation_arbitrary_steps(fhe, keys):
    """Non-power-of-two hoisted rotations (the whole point of hoisting —
    e.g. matrix-vector diagonals): galoiskey_gen for g outside the default
    power-of-two set and the rotation itself must work, not KeyError
    (review finding: ctx.galois_src only held the default set; any other
    element crashed keygen, apply_galois_hoisted's c0 path, and therefore
    rotate_rows_hoisted)."""
    pk, sk, _ = keys
    n = fhe.params.n
    m = 2 * n
    half = n // 2
    steps = [1, 3, 5]  # 3 and 5 need g = 3^3, 3^5 mod 2n: not default keys
    elements = [pow(3, s, m) for s in steps]
    gk = fhe.galoiskey_gen(sk, elements=elements)
    vals = list(range(1, half + 1))
    ct = fhe.encrypt(fhe.encode(vals), pk)
    outs = fhe.rotate_rows_hoisted(ct, steps, gk)
    for s, out in zip(steps, outs):
        got = fhe.decode(fhe.decrypt(out, sk))
        want = vals[s:] + vals[:s]
        assert list(got[:half]) == want, f"step {s}"


def test_sum_slots_hoisted_radix4(fhe, keys):
    """sum_slots with sum_slots_elements() keys takes the radix-4 hoisted
    path (three rotations per stage share one gadget decomposition) and
    still lands every slot on the total sum."""
    pk, sk, rlk = keys
    gk = fhe.galoiskey_gen(sk, elements=fhe.sum_slots_elements())
    n = fhe.params.n
    vals = np.arange(1, n + 1, dtype=np.int64) % fhe.params.t
    ct = fhe.encrypt(fhe.encode(vals), pk)
    total = int(vals.sum() % fhe.params.t)
    out = fhe.decode(fhe.decrypt(fhe.sum_slots(ct, gk), sk))
    assert int(out[0]) == total and int(out[n - 1]) == total


def test_sum_slots(fhe, keys):
    """Inner-sum reduction: every slot ends up holding the total sum."""
    pk, sk, rlk = keys
    gk = fhe.galoiskey_gen(sk)
    n = fhe.params.n
    vals = np.arange(1, n + 1, dtype=np.int64) % fhe.params.t
    ct = fhe.encrypt(fhe.encode(vals), pk)
    total = int(vals.sum() % fhe.params.t)
    out = fhe.decode(fhe.decrypt(fhe.sum_slots(ct, gk), sk))
    assert int(out[0]) == total and int(out[n - 1]) == total


@pytest.mark.parametrize("n", [1024, 2048, 8192, 16384])
def test_galois_folded_factorization_matches_gather(n):
    """The folded-affine automorphism (context.galois_fold_tables +
    bfv._galois_coeff_folded) must equal the plain permutation gather for
    every default Galois element of each ring size it activates on, plus
    a few elements outside the default set."""
    from fhe_jax.scheme import bfv as _bfv
    from fhe_jax.scheme import context as _context

    rng = np.random.default_rng(n)
    p = np.uint32(1073479681)
    x = jnp.asarray(rng.integers(0, p, (2, 3, n), dtype=np.uint32))
    extra = (9, pow(3, 5, 2 * n), pow(3, -3, 2 * n))
    for g in _context.default_galois_elements(n) + extra:
        ft = _context.galois_fold_tables(n, int(g))
        assert ft is not None, (n, g)
        got = np.asarray(_bfv._galois_coeff_folded(
            x, ft, jnp.asarray(p)[None, None, None, None]))
        src, neg = _context.galois_permutation(n, int(g))
        gat = np.asarray(x)[:, :, src]
        want = np.where(neg[None, None, :],
                        np.where(gat == 0, gat, p - gat), gat)
        np.testing.assert_array_equal(got, want, err_msg=f"n={n} g={g}")


def test_galois_small_rings_use_the_plain_gather():
    """Below n=1024 there are no folded tables, so _apply_galois_coeff
    takes the plain gather path."""
    from fhe_jax.scheme import context as _context

    assert _context.galois_fold_tables(512, 3) is None
