"""MXU four-step NTT engine (ops/ntt_mxu.py): exactness against the VPU
engine and the host oracle."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_jax import primes as _primes
from fhe_jax.ops import ntt as _ntt
from fhe_jax.ops import ntt_mxu as _mxu


@pytest.fixture(scope="module", params=[256, 1024])
def engines(request):
    n = request.param
    ps = _primes.find_ntt_primes(n, 2, bits=30)
    return n, _ntt.build_tables(n, ps), _mxu.build_mxu_tables(n, ps)


def _rand(rng, tb, n, batch):
    parr = np.asarray(tb.p, dtype=np.uint64)
    return jnp.asarray(
        rng.integers(0, parr[:, None, None],
                     size=(len(parr), batch, n)).astype(np.uint32))


def test_roundtrip_exact(engines):
    n, tb, mt = engines
    rng = np.random.default_rng(1)
    x = _rand(rng, tb, n, 3)
    rt = _mxu.ntt_inverse(_mxu.ntt_forward(x, mt), mt)
    assert np.array_equal(rt, x)


def test_polymul_bit_exact_vs_vpu_engine(engines):
    """Order conventions differ (four-step natural vs merged-psi
    bit-reversed) but the polymul result must be identical."""
    n, tb, mt = engines
    rng = np.random.default_rng(2)
    a = _rand(rng, tb, n, 2)
    b = _rand(rng, tb, n, 2)
    got = _mxu.polymul_negacyclic(a, b, mt)
    want = _ntt.polymul_negacyclic(a, b, tb)
    assert np.array_equal(got, want)


def test_forward_is_negacyclic_evaluation(engines):
    """Spot-check the four-step output against a direct evaluation:
    X[j2 + n2*j1] must equal sum_i x_i * psi^i * w^(i*(j2 + n2*j1)) mod p."""
    n, tb, mt = engines
    p = int(np.asarray(tb.p)[0])
    psi = _primes.negacyclic_psi(n, p)
    w = pow(psi, 2, p)
    rng = np.random.default_rng(3)
    x = [int(v) for v in rng.integers(0, p, size=n)]
    xs = jnp.asarray(np.array(x, dtype=np.uint32)[None, None, :])
    got = np.asarray(_mxu.ntt_forward(
        jnp.broadcast_to(xs, (mt.p.shape[0], 1, n)), mt))[0, 0]
    for j in rng.integers(0, n, size=4):
        j = int(j)
        want = sum(
            x[i] * pow(psi, i, p) % p * pow(w, i * j % (n), p) for i in range(n)
        ) % p
        assert int(got[j]) == want, j


def test_scheme_multiply_mxu_dispatch_bit_exact():
    """The production multiply with use_mxu=True must be bit-exact with the
    CT-engine multiply (round-1 review item 4: integrate the MXU NTT)."""
    import jax.random as jrandom
    from fhe_jax.params import SecurityParams, make_scheme_params
    from fhe_jax.scheme import bfv
    from fhe_jax.scheme.context import make_context

    params = make_scheme_params(SecurityParams(
        poly_degree=256, log_q=90, lambda_=0, hamming_weight=8))
    ctx_ref = make_context(params)
    ctx_mxu = make_context(params, use_mxu=True)
    key = jrandom.PRNGKey(9)
    k1, k2, k3, k4 = jrandom.split(key, 4)
    pk, sk = jax.jit(bfv.keygen)(ctx_ref, k1)
    from fhe_jax.scheme.encoder import BatchEncoder
    enc = BatchEncoder(params)
    ct1 = jax.jit(bfv.encrypt)(ctx_ref, k2, pk, enc.encode([5, 10, 15, 20]))
    ct2 = jax.jit(bfv.encrypt)(ctx_ref, k3, pk, enc.encode([3, 6, 9, 12]))
    want = jax.jit(bfv.multiply_no_relin)(ctx_ref, ct1, ct2)
    got = jax.jit(bfv.multiply_no_relin)(ctx_mxu, ct1, ct2)
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))


def test_ntt_16384_roundtrip_jnp():
    """n = 16384 (the reference's declared maximum, docs/API_REFERENCE.md:62)
    round-trips on the stage-sweep engine."""
    from fhe_jax import primes as _primes
    from fhe_jax.ops import ntt as _ntt2
    n = 16384
    ps = _primes.find_ntt_primes(n, 1)
    tb = _ntt2.build_tables(n, ps)
    a = jnp.asarray(np.random.default_rng(0).integers(
        0, ps[0], (1, 1, n), dtype=np.uint32))
    f = jax.jit(_ntt2.ntt_forward)(a, tb)
    back = jax.jit(_ntt2.ntt_inverse)(f, tb)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(a))
