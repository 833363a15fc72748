"""Serialization round-trip tests (capability the reference lacks,
SURVEY.md §5 'Checkpoint / resume')."""

import numpy as np
import pytest

from fhe_jax import FHE
from fhe_jax.utils import serialize


@pytest.fixture(scope="module")
def small_fhe():
    fhe = FHE(poly_degree=256, log_q=60, seed=3)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk, elements=[3])
    return fhe, pk, sk, rlk, gk


def test_roundtrip_all_types(tmp_path, small_fhe):
    fhe, pk, sk, rlk, gk = small_fhe
    pt = fhe.encode([1, 2, 3])
    ct = fhe.encrypt(pt, pk)
    path = tmp_path / "bundle.npz"
    serialize.save(path, {"pk": pk, "sk": sk, "rlk": rlk, "gk": gk,
                          "pt": pt, "ct": ct})
    out = serialize.load(path)

    assert np.array_equal(out["pk"].data, pk.data)
    assert np.array_equal(out["sk"].data, sk.data)
    assert np.array_equal(out["rlk"].data, rlk.data)
    assert out["gk"].elements() == gk.elements()
    for g in gk.elements():
        assert np.array_equal(out["gk"].data[g], gk.data[g])
    assert np.array_equal(out["pt"].data, pt.data)
    assert out["pt"].is_ntt_form == pt.is_ntt_form
    assert np.array_equal(out["ct"].data, ct.data)
    assert out["ct"].level == ct.level
    assert out["ct"].is_ntt_form == ct.is_ntt_form


def test_loaded_keys_decrypt(tmp_path, small_fhe):
    """A ciphertext+key saved and reloaded must still decrypt correctly."""
    fhe, pk, sk, rlk, gk = small_fhe
    ct = fhe.encrypt(fhe.encode([7, 8, 9]), pk)
    path = tmp_path / "ct.npz"
    serialize.save(path, {"ct": ct, "sk": sk})
    out = serialize.load(path)
    vals = fhe.decode(fhe.decrypt(out["ct"], out["sk"]))
    assert list(vals[:3]) == [7, 8, 9]


def test_params_roundtrip(tmp_path):
    from fhe_jax.params import SecurityParams, make_scheme_params
    p = make_scheme_params(SecurityParams(poly_degree=256, log_q=60))
    path = tmp_path / "p.npz"
    serialize.save(path, {"params": p})
    assert serialize.load(path)["params"] == p


def test_rejects_unknown_type(tmp_path):
    with pytest.raises(TypeError):
        serialize.save(tmp_path / "x.npz", {"bad": object()})


def test_rejects_slash_names(tmp_path, small_fhe):
    fhe, pk, *_ = small_fhe
    with pytest.raises(ValueError):
        serialize.save(tmp_path / "x.npz", {"a/b": pk})


def test_ciphertext_scale_t_roundtrips(tmp_path):
    """BGV mod-switched ciphertexts carry scale_t; dropping it on save/load
    silently corrupts decryption (review finding)."""
    fhe = FHE(poly_degree=256, log_q=90, seed=12, scheme="bgv")
    pk, sk = fhe.keygen()
    ct = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([41, 42]), pk))
    assert ct.scale_t != 1
    path = tmp_path / "bgv_ct.npz"
    serialize.save(path, {"ct": ct, "sk": sk})
    out = serialize.load(path)
    assert out["ct"].scale_t == ct.scale_t
    got = fhe.decode(fhe.decrypt(out["ct"], out["sk"]))
    assert list(got[:2]) == [41, 42]


def test_bootstrap_key_roundtrips(tmp_path):
    """RGSW bootstrap keys persist (production workflows generate them once
    per secret key)."""
    import jax.random as jrandom
    from fhe_jax.params import SecurityParams, make_scheme_params
    from fhe_jax.scheme import bfv, bootstrap
    from fhe_jax.scheme.context import make_context

    params = make_scheme_params(SecurityParams(
        poly_degree=64, log_q=60, lambda_=0, hamming_weight=8))
    ctx = make_context(params)
    kg, kb = jrandom.split(jrandom.PRNGKey(0))
    _, sk = bfv.keygen(ctx, kg)
    bsk = bootstrap.make_bootstrap_key(ctx, kb, sk)
    path = tmp_path / "bsk.npz"
    serialize.save(path, {"bsk": bsk})
    out = serialize.load(path)["bsk"]
    assert out.level == bsk.level
    np.testing.assert_array_equal(np.asarray(out.pos), np.asarray(bsk.pos))
    np.testing.assert_array_equal(np.asarray(out.neg), np.asarray(bsk.neg))
