"""Device NTT engine vs oracle: bit-exact transforms, round-trip, convolution.

Mirrors the reference's NTT tests (tests/test_fhe.cu:65-167) with actual
bit-exact assertions against the host oracle."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_jax import oracle, primes
from fhe_jax.ops import ntt

# jit once per shape: eager dispatch on this 1-core box is pathologically slow
fwd = jax.jit(ntt.ntt_forward)
inv = jax.jit(ntt.ntt_inverse)
pmul = jax.jit(ntt.polymul_negacyclic)

RNG = np.random.default_rng(7)


def make(n, k, batch):
    ps = primes.find_ntt_primes(n, k)
    tb = ntt.build_tables(n, ps)
    a = np.stack([
        np.stack([RNG.integers(0, p, size=n, dtype=np.uint32) for _ in range(batch)])
        for p in ps
    ])
    return ps, tb, a


@pytest.mark.parametrize("n,k,batch", [(16, 1, 1), (64, 3, 2), (256, 2, 3)])
def test_forward_bit_exact_vs_oracle(n, k, batch):
    ps, tb, a = make(n, k, batch)
    got = np.asarray(fwd(jnp.asarray(a), tb))
    for i, p in enumerate(ps):
        otb = oracle.build_ntt_tables(n, p)
        for j in range(batch):
            want = oracle.ntt_forward([int(x) for x in a[i, j]], otb)
            np.testing.assert_array_equal(got[i, j], np.array(want, dtype=np.uint32))


@pytest.mark.parametrize("n,k,batch", [(16, 1, 1), (64, 3, 2), (256, 2, 3)])
def test_inverse_bit_exact_vs_oracle(n, k, batch):
    ps, tb, a = make(n, k, batch)
    got = np.asarray(inv(jnp.asarray(a), tb))
    for i, p in enumerate(ps):
        otb = oracle.build_ntt_tables(n, p)
        for j in range(batch):
            want = oracle.ntt_inverse([int(x) for x in a[i, j]], otb)
            np.testing.assert_array_equal(got[i, j], np.array(want, dtype=np.uint32))


@pytest.mark.parametrize("n,k", [(1024, 3), (4096, 2)])
def test_roundtrip_large(n, k):
    """NTT round-trip exactness — the reference's primary NTT correctness bar
    (tests/test_fhe.cu:108-116, there at n=1024)."""
    ps, tb, a = make(n, k, 2)
    f = fwd(jnp.asarray(a), tb)
    back = np.asarray(inv(f, tb))
    np.testing.assert_array_equal(back, a)


def test_polymul_matches_oracle():
    n, k = 128, 3
    ps, tb, a = make(n, k, 2)
    _, _, b = make(n, k, 2)
    b = np.stack([bb % p for bb, p in zip(b, ps)])  # same primes as a
    got = np.asarray(pmul(jnp.asarray(a), jnp.asarray(b), tb))
    for i, p in enumerate(ps):
        for j in range(2):
            want = oracle.negacyclic_mul_mod(
                [int(x) for x in a[i, j]], [int(x) for x in b[i, j]], p)
            np.testing.assert_array_equal(got[i, j], np.array(want, dtype=np.uint32))


def test_jit_compiles_once_and_matches():
    n, k = 256, 3
    ps, tb, a = make(n, k, 4)
    got = np.asarray(pmul(jnp.asarray(a), jnp.asarray(a), tb))
    # second call reuses the compiled executable and must agree
    got2 = np.asarray(pmul(jnp.asarray(a), jnp.asarray(a), tb))
    np.testing.assert_array_equal(got, got2)


def test_tables_build_at_max_degree():
    """n = 32768 is the largest batching-compatible degree (2n | t-1);
    tables must build and round-trip (k=1 to keep CI time sane)."""
    import numpy as np
    import jax.numpy as jnp
    from fhe_jax import primes as _primes
    from fhe_jax.ops import ntt as _ntt

    n = 32768
    p = _primes.find_ntt_primes(n, 1, bits=30)[0]
    tb = _ntt.build_tables(n, [p])
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, p, size=(1, 1, n)).astype(np.uint32))
    rt = _ntt.ntt_inverse(_ntt.ntt_forward(x, tb), tb)
    assert np.array_equal(rt, x)


# Larger rings, one prime each at n >= 4096 so the pure-Python oracle stays
# cheap; (n, k, batch) up to n = 32768, the largest batching degree.
ORACLE_SHAPES = [(512, 3, 2), (1024, 2, 1), (4096, 1, 2), (8192, 1, 1),
                 (32768, 1, 1)]


def _oracle_rows(ps, a, fn):
    return np.stack([
        np.stack([np.array(fn([int(x) for x in a[i, j]],
                              oracle.build_ntt_tables(a.shape[2], p)),
                           dtype=np.uint32) for j in range(a.shape[1])])
        for i, p in enumerate(ps)])


@pytest.mark.parametrize("n,k,batch", ORACLE_SHAPES)
def test_forward_vs_oracle_large(n, k, batch):
    ps, tb, a = make(n, k, batch)
    got = np.asarray(fwd(jnp.asarray(a), tb))
    np.testing.assert_array_equal(got, _oracle_rows(ps, a, oracle.ntt_forward))


@pytest.mark.parametrize("n,k,batch", ORACLE_SHAPES)
def test_inverse_vs_oracle_large(n, k, batch):
    ps, tb, a = make(n, k, batch)
    got = np.asarray(inv(jnp.asarray(a), tb))
    np.testing.assert_array_equal(got, _oracle_rows(ps, a, oracle.ntt_inverse))


@pytest.mark.parametrize("n,k,batch", ORACLE_SHAPES[:4])
def test_polymul_vs_oracle_transforms(n, k, batch):
    """polymul == oracle inverse of the pointwise product of oracle forwards
    (the schoolbook oracle is quadratic, too slow past a few hundred)."""
    ps, tb, a = make(n, k, batch)
    _, _, b = make(n, k, batch)
    b = np.stack([bb % p for bb, p in zip(b, ps)])
    got = np.asarray(pmul(jnp.asarray(a), jnp.asarray(b), tb))
    fa = _oracle_rows(ps, a, oracle.ntt_forward).astype(np.uint64)
    fb = _oracle_rows(ps, b, oracle.ntt_forward).astype(np.uint64)
    prod = (fa * fb % np.array(ps, dtype=np.uint64)[:, None, None]
            ).astype(np.uint32)
    np.testing.assert_array_equal(
        got, _oracle_rows(ps, prod, oracle.ntt_inverse))
