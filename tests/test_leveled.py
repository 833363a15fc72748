"""Leveled-operation tests: multiply / relinearize / plain ops / rotations
at level > 0, for both schemes.  Keys are generated once at level 0 and
switched down on the fly (bfv._switch_keys_down)."""

import numpy as np
import pytest

from fhe_jax import FHE
from fhe_jax.params import SecurityParams, make_scheme_params

PARAMS = make_scheme_params(
    SecurityParams(poly_degree=256, log_q=150, hamming_weight=32))  # k=5


@pytest.fixture(scope="module", params=["bfv", "bgv"])
def setup(request):
    fhe = FHE(PARAMS, seed=13, scheme=request.param)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    return fhe, pk, sk, rlk


def test_multiply_at_level_one(setup):
    fhe, pk, sk, rlk = setup
    ct1 = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk))
    ct2 = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk))
    assert ct1.level == 1
    prod = fhe.multiply(ct1, ct2, rlk)
    assert prod.level == 1
    got = fhe.decode(fhe.decrypt(prod, sk))
    assert list(got[:4]) == [15, 60, 135, 240]


def test_multiply_at_level_two(setup):
    fhe, pk, sk, rlk = setup
    ct1 = fhe.mod_switch_to_level(fhe.encrypt(fhe.encode([7, 2]), pk), 2)
    ct2 = fhe.mod_switch_to_level(fhe.encrypt(fhe.encode([4, 5]), pk), 2)
    got = fhe.decode(fhe.decrypt(fhe.multiply(ct1, ct2, rlk), sk))
    assert list(got[:2]) == [28, 10]


def test_depth_two_circuit_with_switching(setup):
    """(a*b) switched down, then *c — a real leveled circuit."""
    fhe, pk, sk, rlk = setup
    a = fhe.encrypt(fhe.encode([2, 3]), pk)
    b = fhe.encrypt(fhe.encode([5, 7]), pk)
    c = fhe.encrypt(fhe.encode([11, 13]), pk)
    ab = fhe.mod_switch_to_next(fhe.multiply(a, b, rlk))
    c1 = fhe.mod_switch_to_next(c)
    abc = fhe.multiply(ab, c1, rlk)
    got = fhe.decode(fhe.decrypt(abc, sk))
    assert list(got[:2]) == [110, 273]


def test_plain_ops_at_level(setup):
    fhe, pk, sk, _ = setup
    ct = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([10, 20, 30]), pk))
    pt = fhe.encode([4, 4, 4])
    assert list(fhe.decode(fhe.decrypt(fhe.add_plain(ct, pt), sk))[:3]) == \
        [14, 24, 34]
    assert list(fhe.decode(fhe.decrypt(fhe.sub_plain(ct, pt), sk))[:3]) == \
        [6, 16, 26]
    assert list(fhe.decode(fhe.decrypt(fhe.multiply_plain(ct, pt), sk))[:3]) == \
        [40, 80, 120]


def test_rotation_at_level(setup):
    fhe, pk, sk, _ = setup
    gal = fhe.galoiskey_gen(sk)
    half = PARAMS.slot_count
    vals = list(range(1, half + 1))
    ct = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode(vals), pk))
    got = fhe.decode(fhe.decrypt(fhe.rotate_rows(ct, 1, gal), sk))
    assert list(got[:half]) == vals[1:] + vals[:1]


def test_relin_key_cache_consistency(setup):
    """Cached down-switched keys must give the same result as on-the-fly."""
    fhe, pk, sk, rlk = setup
    from fhe_jax.scheme import bfv as _bfv
    ct1 = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([5, 6]), pk))
    ct2 = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([7, 8]), pk))
    via_cache = fhe.multiply(ct1, ct2, rlk)           # FHE wrapper path
    mod = fhe._scheme
    direct = mod.multiply(fhe.ctx, ct1, ct2, rlk)     # on-the-fly switching
    np.testing.assert_array_equal(
        np.asarray(via_cache.data), np.asarray(direct.data))
    # cache populated exactly once per (rlk, level)
    assert (id(rlk), 1) in fhe._rlk_cache


def test_rlk_cache_evicts_on_gc():
    """Dropping the rlk object must evict its cached per-level keys
    (no HBM pinning of dead key material)."""
    import gc
    fhe = FHE(PARAMS, seed=29)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    ct = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([3]), pk))
    fhe.multiply(ct, ct, rlk)
    assert len(fhe._rlk_cache) == 1
    del rlk
    gc.collect()
    assert len(fhe._rlk_cache) == 0
