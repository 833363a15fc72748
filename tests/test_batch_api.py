"""Batch entry points equal their single-ciphertext counterparts.

The batch APIs (multiply_batch, encrypt_batch, decrypt_batch,
apply_galois_batch, apply_galois_hoisted_batch, the hoisted inner sum and
BGV's multiply_batch) are the serving surface; element i of each must be
what the single op gives for input i."""

import numpy as np
import pytest
import jax
import jax.random as jrandom

from fhe_jax import FHE
from fhe_jax.params import SecurityParams, make_scheme_params
from fhe_jax.scheme import bfv, bgv

N = 256
B = 3


def _params(t=65537):
    return make_scheme_params(SecurityParams(
        poly_degree=N, log_q=120, hamming_weight=32, plain_modulus=t))


@pytest.fixture(scope="module")
def env():
    fhe = FHE(_params(), seed=21)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk)
    rng = np.random.default_rng(5)
    vals = [rng.integers(0, fhe.params.t, N) for _ in range(2 * B)]
    cts = [fhe.encrypt(fhe.encode(v), pk) for v in vals]
    return fhe, pk, sk, rlk, gk, vals, cts


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))


def test_multiply_batch_equals_singles(env):
    fhe, _, _, rlk, _, _, cts = env
    outs = fhe.multiply_batch(cts[:B], cts[B:], rlk)
    assert len(outs) == B
    for i in range(B):
        _same(outs[i], fhe.multiply(cts[i], cts[B + i], rlk))


def test_encrypt_batch_equals_fold_in_singles(env):
    fhe, pk, _, _, _, vals, _ = env
    key = jrandom.PRNGKey(8)
    pts = [fhe.encode(v) for v in vals[:B]]
    outs = jax.jit(bfv.encrypt_batch)(fhe.ctx, key, pk, pts)
    enc = jax.jit(bfv.encrypt)
    for i in range(B):
        _same(outs[i], enc(fhe.ctx, jrandom.fold_in(key, i), pk, pts[i]))


def test_decrypt_batch_equals_singles(env):
    fhe, _, sk, _, _, vals, cts = env
    outs = fhe.decrypt_batch(cts[:B], sk)
    for i in range(B):
        _same(outs[i], fhe.decrypt(cts[i], sk))
        assert np.array_equal(fhe.decode(outs[i]), vals[i])


def test_apply_galois_batch_equals_singles(env):
    fhe, _, _, _, gk, _, cts = env
    g = pow(3, 2, 2 * N)
    outs = jax.jit(lambda c, xs, k: bfv.apply_galois_batch(c, xs, g, k))(
        fhe.ctx, cts[:B], gk)
    single = jax.jit(lambda c, x, k: bfv.apply_galois(c, x, g, k))
    for i in range(B):
        _same(outs[i], single(fhe.ctx, cts[i], gk))


def test_rotate_rows_batch_equals_singles(env):
    fhe, _, _, _, gk, _, cts = env
    outs = fhe.rotate_rows_batch(cts[:B], 3, gk)
    for i in range(B):
        _same(outs[i], fhe.rotate_rows(cts[i], 3, gk))


def test_apply_galois_hoisted_batch_equals_hoisted(env):
    fhe, _, sk, _, gk, vals, cts = env
    steps = (1, 2, 4)
    outs = fhe.rotate_rows_hoisted_batch(cts[:B], steps, gk)
    half = N // 2
    for c in range(B):
        singles = fhe.rotate_rows_hoisted(cts[c], steps, gk)
        for e, s in enumerate(steps):
            _same(outs[c][e], singles[e])
            rows = vals[c].reshape(2, half)
            want = np.roll(rows, -s, axis=1).reshape(-1)
            assert np.array_equal(fhe.decode(fhe.decrypt(outs[c][e], sk)),
                                  want)


def test_hoisted_sum_decrypts_to_composed_rotations(env):
    fhe, _, sk, _, gk, _, cts = env
    elements = tuple(pow(3, s, 2 * N) for s in (1, 2, 4))
    got = jax.jit(lambda c, x, k: bfv.apply_galois_hoisted_sum(
        c, x, elements, k))(fhe.ctx, cts[0], gk)
    acc = cts[0]
    for g in elements:
        acc = fhe.add(acc, jax.jit(lambda c, x, k, g=g: bfv.apply_galois(
            c, x, g, k))(fhe.ctx, cts[0], gk))
    np.testing.assert_array_equal(fhe.decode(fhe.decrypt(got, sk)),
                                  fhe.decode(fhe.decrypt(acc, sk)))


def test_sum_slots_radix4_keys_match_default_keys(env):
    fhe, _, sk, _, gk, vals, cts = env
    gk4 = fhe.galoiskey_gen(sk, elements=fhe.sum_slots_elements())
    want = int(vals[1].sum() % fhe.params.t)
    for keys in (gk, gk4):
        got = fhe.decode(fhe.decrypt(fhe.sum_slots(cts[1], keys), sk))
        assert np.all(got == want)


def test_bgv_multiply_batch_equals_singles():
    fhe = FHE(_params(), seed=4, scheme="bgv")
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    rng = np.random.default_rng(6)
    vals = [rng.integers(0, fhe.params.t, N) for _ in range(4)]
    cts = [fhe.encrypt(fhe.encode(v), pk) for v in vals]
    outs = jax.jit(bgv.multiply_batch)(fhe.ctx, cts[:2], cts[2:], rlk)
    for i in range(2):
        _same(outs[i], fhe.multiply(cts[i], cts[2 + i], rlk))
        got = fhe.decode(fhe.decrypt(outs[i], sk)).astype(np.int64)
        assert np.array_equal(got, vals[i] * vals[2 + i] % fhe.params.t)


@pytest.mark.parametrize("t", [65537, 786433])
def test_decrypt_at_plain_modulus(t):
    fhe = FHE(_params(t), seed=9)
    pk, sk = fhe.keygen()
    rng = np.random.default_rng(t)
    vals = [rng.integers(0, t, N) for _ in range(2)]
    cts = [fhe.encrypt(fhe.encode(v), pk) for v in vals]
    for v, ct, pt in zip(vals, cts, fhe.decrypt_batch(cts, sk)):
        _same(pt, fhe.decrypt(ct, sk))
        assert np.array_equal(fhe.decode(pt), v)
