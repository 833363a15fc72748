"""Cross-op NTT-form residency (reference include/fhe.cuh:68 `is_ntt_form`):
eval-domain ciphertexts flow through the plain
ops without per-op INTT+NTT round trips, bit-exact with the coefficient
path, and the FHE wrapper caches NTT-form plaintext operands per
(Plaintext, level)."""

import numpy as np
import pytest

from fhe_jax import FHE
from fhe_jax.params import SecurityParams, make_scheme_params


@pytest.fixture(scope="module", params=["bfv", "bgv"])
def setup(request):
    params = make_scheme_params(SecurityParams(
        poly_degree=256, log_q=120, lambda_=0, hamming_weight=16))
    fhe = FHE(params, seed=3, scheme=request.param)
    pk, sk = fhe.keygen()
    return fhe, pk, sk


def test_resident_plain_chain_bit_exact(setup):
    """to_ntt -> (multiply_plain, add_plain, sub_plain, add) -> to_coeff is
    bit-exact with the all-coefficient-domain chain (INTT is linear and
    exact mod p, so deferring it commutes with every resident op)."""
    fhe, pk, sk = setup
    t, n = fhe.params.t, fhe.params.n
    rng = np.random.default_rng(0)
    v = rng.integers(0, t, n)
    w = rng.integers(0, 50, n)
    u = rng.integers(0, t, n)
    ct = fhe.encrypt(fhe.encode(v), pk)
    pt_w, pt_u = fhe.encode(w), fhe.encode(u)

    # coefficient-domain chain of record
    ref = fhe.add_plain(fhe.multiply_plain(ct, pt_w), pt_u)
    ref = fhe.sub_plain(fhe.add(ref, ref), pt_u)

    # resident chain: one to_ntt, one to_coeff
    res = fhe.to_ntt(ct)
    assert res.is_ntt_form
    res = fhe.add_plain(fhe.multiply_plain(res, pt_w), pt_u)
    assert res.is_ntt_form, "plain ops must preserve eval-domain residency"
    res = fhe.sub_plain(fhe.add(res, res), pt_u)
    res = fhe.to_coeff(res)
    assert not res.is_ntt_form

    assert np.array_equal(np.asarray(res.data), np.asarray(ref.data)), \
        "resident chain is not bit-exact vs the coefficient chain"
    model = ((v * w % t + u) * 2 - u) % t
    got = fhe.decode(fhe.decrypt(res, sk)).astype(np.int64)
    assert np.array_equal(got, model)


def test_plain_operand_cache(setup):
    """cache_operand=True reuses one NTT-form operand per (pt, level) and
    stays bit-exact; the cache evicts when the Plaintext is dropped."""
    fhe, pk, sk = setup
    t, n = fhe.params.t, fhe.params.n
    rng = np.random.default_rng(1)
    v = rng.integers(0, t, n)
    w = rng.integers(0, 50, n)
    ct = fhe.encrypt(fhe.encode(v), pk)
    pt = fhe.encode(w)

    fhe._plain_ntt_cache.clear()
    a = fhe.multiply_plain(ct, pt, cache_operand=True)
    assert len(fhe._plain_ntt_cache) == 1
    b = fhe.multiply_plain(ct, pt, cache_operand=True)  # cache hit
    assert len(fhe._plain_ntt_cache) == 1
    plain = fhe.multiply_plain(ct, pt)                  # uncached path
    assert np.array_equal(np.asarray(a.data), np.asarray(b.data))
    assert np.array_equal(np.asarray(a.data), np.asarray(plain.data))
    got = fhe.decode(fhe.decrypt(a, sk)).astype(np.int64)
    assert np.array_equal(got, v * w % t)

    del pt, a, b, plain
    import gc
    gc.collect()
    assert len(fhe._plain_ntt_cache) == 0, "weakref eviction failed"


def test_resident_dot_product(setup):
    """K-term plaintext dot product entirely in eval domain: the classic
    residency workload (K products + K-1 adds, ONE transform each way)."""
    fhe, pk, sk = setup
    t, n = fhe.params.t, fhe.params.n
    rng = np.random.default_rng(2)
    K = 4
    vs = [rng.integers(0, t, n) for _ in range(K)]
    ws = [rng.integers(0, 40, n) for _ in range(K)]
    cts = [fhe.to_ntt(fhe.encrypt(fhe.encode(v), pk)) for v in vs]
    pts = [fhe.encode(w) for w in ws]

    acc = None
    for c, p in zip(cts, pts):
        term = fhe.multiply_plain(c, p, cache_operand=True)
        acc = term if acc is None else fhe.add(acc, term)
    assert acc.is_ntt_form
    out = fhe.to_coeff(acc)
    model = sum(v * w for v, w in zip(vs, ws)) % t
    got = fhe.decode(fhe.decrypt(out, sk)).astype(np.int64)
    assert np.array_equal(got, model)


def test_rotation_accepts_ntt_form(setup):
    """Key-switching ops convert internally: a resident ct can be rotated
    directly (scheme-boundary conversion, not a caller burden)."""
    fhe, pk, sk = setup
    n, t = fhe.params.n, fhe.params.t
    gk = fhe.galoiskey_gen(sk)
    vals = np.arange(n) % t
    ct = fhe.to_ntt(fhe.encrypt(fhe.encode(vals), pk))
    rot = fhe.rotate_rows(ct, 1, gk)
    half = n // 2
    model = np.concatenate(
        [np.roll(vals[:half], -1), np.roll(vals[half:], -1)])
    got = fhe.decode(fhe.decrypt(rot, sk)).astype(np.int64)
    assert np.array_equal(got, model)
