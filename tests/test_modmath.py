"""Bit-exact tests of the uint32 modular-arithmetic layer vs Python ints.

Counterpart of the reference's bigint tests (tests/test_fhe.cu:24-63), but
with actual assertions and exhaustive random coverage."""

import numpy as np
import pytest
import jax.numpy as jnp

from fhe_jax import primes
from fhe_jax.ops import modmath as mm

PRIMES = primes.find_ntt_primes(4096, 4) + [primes.find_ntt_primes(8192, 1)[0]]
RNG = np.random.default_rng(123)


def rand_u32(n, bound):
    return RNG.integers(0, bound, size=n, dtype=np.uint32)


def test_umul32_wide():
    a = np.concatenate([rand_u32(1000, 1 << 32), [0, 1, 0xFFFFFFFF]]).astype(np.uint32)
    b = np.concatenate([rand_u32(1000, 1 << 32), [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF]]).astype(np.uint32)
    hi, lo = mm.umul32_wide(jnp.asarray(a), jnp.asarray(b))
    prod = a.astype(object) * b.astype(object)
    np.testing.assert_array_equal(np.asarray(hi), np.array([p >> 32 for p in prod], dtype=np.uint32))
    np.testing.assert_array_equal(np.asarray(lo), np.array([p & 0xFFFFFFFF for p in prod], dtype=np.uint32))


@pytest.mark.parametrize("p", PRIMES)
def test_add_sub_mod(p):
    a = np.concatenate([rand_u32(500, p), [0, p - 1, p - 1]]).astype(np.uint32)
    b = np.concatenate([rand_u32(500, p), [0, p - 1, 1]]).astype(np.uint32)
    got_add = np.asarray(mm.add_mod(jnp.asarray(a), jnp.asarray(b), jnp.uint32(p)))
    got_sub = np.asarray(mm.sub_mod(jnp.asarray(a), jnp.asarray(b), jnp.uint32(p)))
    np.testing.assert_array_equal(got_add, (a.astype(object) + b.astype(object)) % p)
    np.testing.assert_array_equal(got_sub, (a.astype(object) - b.astype(object)) % p)


@pytest.mark.parametrize("p", PRIMES)
def test_mul_mod_barrett(p):
    mu = mm.barrett_precompute(p)
    a = np.concatenate([rand_u32(2000, p), [0, 1, p - 1, p - 1]]).astype(np.uint32)
    b = np.concatenate([rand_u32(2000, p), [p - 1, p - 1, p - 1, 1]]).astype(np.uint32)
    got = np.asarray(mm.mul_mod_barrett(jnp.asarray(a), jnp.asarray(b),
                                        jnp.uint32(p), jnp.uint32(mu)))
    want = (a.astype(object) * b.astype(object)) % p
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("p", PRIMES)
def test_mul_mod_shoup(p):
    ws = np.concatenate([rand_u32(50, p), [0, 1, p - 1]]).astype(np.uint32)
    for w in ws:
        w_sh = mm.shoup_precompute(int(w), p)
        # Shoup accepts ANY x < 2^32 (lazy inputs), not just x < p
        x = np.concatenate([rand_u32(500, 1 << 32), [0, 1, p - 1, 0xFFFFFFFF]]).astype(np.uint32)
        got = np.asarray(mm.mul_mod_shoup(jnp.asarray(x), jnp.uint32(int(w)),
                                          jnp.uint32(w_sh), jnp.uint32(p)))
        want = (x.astype(object) * int(w)) % p
        np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("p", PRIMES)
def test_mul_mod_montgomery(p):
    p_neg_inv, r2, r1 = mm.montgomery_precompute(p)
    a = np.concatenate([rand_u32(1000, p), [0, 1, p - 1]]).astype(np.uint32)
    b = np.concatenate([rand_u32(1000, p), [p - 1, p - 1, p - 1]]).astype(np.uint32)
    got = np.asarray(mm.mul_mod_montgomery(jnp.asarray(a), jnp.asarray(b),
                                           jnp.uint32(p), jnp.uint32(p_neg_inv)))
    inv_r = pow(1 << 32, -1, p)
    want = (a.astype(object) * b.astype(object) * inv_r) % p
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("p", PRIMES[:2])
def test_pow_mod(p):
    mu = mm.barrett_precompute(p)
    base = rand_u32(64, p)
    for e in (0, 1, 2, 5, p - 2, (p - 1) // 2):
        got = np.asarray(mm.pow_mod(jnp.asarray(base), e, jnp.uint32(p), jnp.uint32(mu)))
        want = np.array([pow(int(x), e, p) for x in base], dtype=np.uint32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", PRIMES)
def test_barrett_reduce_u32(p):
    mu = mm.barrett_precompute(p)
    x = np.concatenate([rand_u32(2000, 1 << 32), [0, p, 2 * p, 0xFFFFFFFF]]).astype(np.uint32)
    got = np.asarray(mm.barrett_reduce_u32(jnp.asarray(x), jnp.uint32(p), jnp.uint32(mu)))
    np.testing.assert_array_equal(got, (x.astype(object) % p).astype(np.uint32))


@pytest.mark.parametrize("p", PRIMES)
def test_reduce_u64(p):
    mu = mm.barrett_precompute(p)
    two32 = (1 << 32) % p
    hi = rand_u32(2000, 1 << 32)
    lo = rand_u32(2000, 1 << 32)
    got = np.asarray(mm.reduce_u64_mod(jnp.asarray(hi), jnp.asarray(lo),
                                       jnp.uint32(p), jnp.uint32(mu), jnp.uint32(two32)))
    want = ((hi.astype(object) << 32) + lo.astype(object)) % p
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_mul_mod_fermat16():
    t = 65537
    a = np.concatenate([rand_u32(3000, t), [0, 1, 65536, 65536]]).astype(np.uint32)
    b = np.concatenate([rand_u32(3000, t), [65536, 65536, 65536, 1]]).astype(np.uint32)
    got = np.asarray(mm.mul_mod_fermat16(jnp.asarray(a), jnp.asarray(b)))
    want = (a.astype(object) * b.astype(object)) % t
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_security_margin_warning():
    """Sub-128-bit parameter sets warn (the reference documents but never
    enforces its own security tables)."""
    import warnings
    import pytest
    from fhe_jax.params import SecurityParams, make_scheme_params, security_margin

    assert security_margin(SecurityParams(poly_degree=8192, log_q=90)) > 0
    assert security_margin(SecurityParams(poly_degree=4096, log_q=120)) < 0
    make_scheme_params.cache_clear()
    with pytest.warns(UserWarning, match="below the requested"):
        make_scheme_params(SecurityParams(poly_degree=4096, log_q=120))
    make_scheme_params.cache_clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_scheme_params(SecurityParams(poly_degree=8192, log_q=90))
    make_scheme_params.cache_clear()


def test_ternary_fixed_weight_properties():
    """The rejection-sampled fixed-weight ternary sampler: exactly h
    nonzeros, values in {1, p-1}, and different keys give different
    supports (smoke)."""
    import jax
    import jax.numpy as jnp
    from fhe_jax.ops import sampling

    p = jnp.asarray([1073479681, 1073184769], dtype=jnp.uint32)
    n, h = 1024, 64
    supports = []
    for seed in range(3):
        v = sampling.ternary_rns(jax.random.PRNGKey(seed), p, 1, n, h)
        v0 = np.asarray(v[0, 0])
        nz = v0 != 0
        assert int(nz.sum()) == h
        assert set(np.unique(v0[nz])) <= {1, int(p[0]) - 1}
        # rows agree across primes on the support and signs
        v1 = np.asarray(v[1, 0])
        assert ((v1 != 0) == nz).all()
        supports.append(frozenset(np.nonzero(nz)[0].tolist()))
    assert len(set(supports)) == 3
