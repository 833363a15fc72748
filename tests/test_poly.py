"""Polynomial-ring layer tests (reference PolynomialOps surface, SURVEY §2.8),
cross-checked against the NTT engine and the host oracle."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_jax import primes as _primes
from fhe_jax.ops import modmath as mm
from fhe_jax.ops import ntt as _ntt
from fhe_jax.ops import poly as _poly
from fhe_jax.ops import rns as _rns

N = 64
K = 2


@pytest.fixture(scope="module")
def tb():
    ps = _primes.find_ntt_primes(N, K, bits=30)
    return _ntt.build_tables(N, ps)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def _rand_poly(rng, tb, batch=2):
    ps = np.asarray(tb.p, dtype=np.uint64)
    return jnp.asarray(
        rng.integers(0, ps[:, None, None], size=(K, batch, N)).astype(np.uint32))


def test_add_sub_roundtrip(tb, rng):
    a = _rand_poly(rng, tb)
    b = _rand_poly(rng, tb)
    s = jax.jit(_poly.add, static_argnums=())(a, b, tb)
    back = _poly.sub(s, b, tb)
    assert np.array_equal(back, a)


def test_mul_scalar_matches_host(tb, rng):
    a = _rand_poly(rng, tb)
    c = 12345
    got = np.asarray(_poly.mul_scalar(a, c, tb))
    ps = np.asarray(tb.p, dtype=np.uint64)
    want = (np.asarray(a, dtype=np.uint64) * c) % ps[:, None, None]
    assert np.array_equal(got, want.astype(np.uint32))


def test_add_scalar_matches_host(tb, rng):
    a = _rand_poly(rng, tb)
    c = 99999
    got = np.asarray(_poly.add_scalar(a, c, tb))
    ps = np.asarray(tb.p, dtype=np.uint64)
    want = (np.asarray(a, dtype=np.uint64) + c) % ps[:, None, None]
    assert np.array_equal(got, want.astype(np.uint32))


def test_mul_ntt_equals_schoolbook(tb, rng):
    """The declared-only mul_negacyclic is the exact-by-construction
    cross-check for the NTT product."""
    a = _rand_poly(rng, tb, batch=1)
    b = _rand_poly(rng, tb, batch=1)
    fast = np.asarray(_poly.mul_ntt(a, b, tb))
    slow = np.asarray(jax.jit(_poly.mul_negacyclic)(a, b, tb))
    assert np.array_equal(fast, slow)


def test_negacyclic_reduce(tb, rng):
    """Splitting a length-2n product and folding must equal the direct
    negacyclic product."""
    ps = [int(x) for x in np.asarray(tb.p)]
    a_int = rng.integers(0, 100, size=N)
    b_int = rng.integers(0, 100, size=N)
    full = np.convolve(a_int, b_int)                  # length 2n-1
    full = np.concatenate([full, [0]])                # length 2n
    want = [(full[:N] - full[N:]) % p for p in ps]
    coeffs2n = jnp.asarray(
        np.stack([full % p for p in ps])[:, None, :].astype(np.uint32))
    got = np.asarray(_poly.negacyclic_reduce(coeffs2n, tb))[:, 0]
    assert np.array_equal(got, np.stack(want).astype(np.uint32))


def test_mod_switch_drop_last(tb, rng):
    """poly.mod_switch = exact ⌊q'/q x⌉ (checked against big-int host math)."""
    ps = [int(x) for x in np.asarray(tb.p)]
    q = ps[0] * ps[1]
    qp = ps[0]
    mc = _rns.make_mod_switch(tuple(ps))
    vals = [int(v) for v in rng.integers(0, q, size=N)]
    res = jnp.asarray(_rns.to_rns_host(vals, ps)[:, None, :])
    got = np.asarray(_poly.mod_switch(res, tb, None, mc))[:, 0]
    # host: centered rounding ⌊q'/q * x⌉ with x centered mod q
    want = []
    for v in vals:
        c = v if v <= q // 2 else v - q
        w = (c * qp + q // 2) // q  # round half up on centered value
        want.append(w % qp)
    assert np.array_equal(got[0], np.array(want, dtype=np.uint32))


def test_estimate_noise_log2(tb):
    data = jnp.zeros((K, 1, N), jnp.uint32).at[:, 0, 3].set(
        jnp.asarray([1 << 10] * K, jnp.uint32))
    out = float(_poly.estimate_noise(data, tb, ()))
    assert abs(out - 10.0) < 1e-5
