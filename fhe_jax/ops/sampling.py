"""Cryptographic samplers on device — deterministic, seedable jax.random.

Replaces the reference's placeholder samplers (SURVEY.md §2.9a):
  * ``sample_uniform_kernel``  — LCG placeholder (``src/polynomial.cu:130-143``)
  * ``sample_gaussian_kernel`` — ``(seed+idx) %% q`` placeholder
    (``src/polynomial.cu:113-128``; real spec: discrete Gaussian sigma=3.2,
    ``docs/ARCHITECTURE.md:197-217``)
  * ``sample_ternary_kernel``  — declared but never defined
    (``include/polynomial.cuh:129-135``, called at ``src/fhe.cu:254``)

All samplers are threefry-counter based (jax.random), so keys/ciphertexts are
reproducible from a seed across chip counts — unlike curand state arrays
(reference ``include/fhe.cuh:146-147``).

Outputs are [k, batch, n] uint32 residue tensors (values represented mod each
prime; negative samples map to p - |v|).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import modmath as mm


def uniform_rns(key, primes_arr, mu_arr, batch: int, n: int) -> jax.Array:
    """Uniform in [0, p) independently per prime — for the 'a' part of keys.

    Draws 64 bits per residue so modulo bias is < 2^-34 (the reference's LCG
    had ~2^-2 bias at 30-bit p)."""
    k = primes_arr.shape[0]
    hi = jax.random.bits(key, (2, k, batch, n), dtype=jnp.uint32)
    p = primes_arr[:, None, None]
    mu = mu_arr[:, None, None]
    two32 = _two32_mod(primes_arr)[:, None, None]
    return mm.reduce_u64_mod(hi[0], hi[1], p, mu, two32)


def _two32_mod(primes_arr):
    # 2^32 mod p = 2^32 - floor(2^32/p)*p; p > 2^29 so floor is in {4..7}
    p64 = primes_arr.astype(jnp.uint32)
    # compute on host-free path: 2^32 mod p == (0 - p) mod p ... in uint32:
    # 2^32 = 0 (mod 2^32), so 2^32 mod p = (2^32 - 4p) ... do it with jnp:
    # q = floor((2^32-1)/p); r = (0 - q*p) in uint32 wraparound gives 2^32 - q*p
    q = jnp.uint32(0xFFFFFFFF) // p64
    r = jnp.uint32(0) - q * p64  # = 2^32 - q*p (wraparound), in [0, 2p)
    return jnp.where(r >= p64, r - p64, r)


def _small_signed_to_rns(vals_i32, primes_arr):
    """[batch, n] int32 small values -> [k, batch, n] residues."""
    p = primes_arr[:, None, None]
    v = vals_i32[None, :, :]
    pos = v >= 0
    mag = jnp.where(pos, v, -v).astype(jnp.uint32)
    return jnp.where(pos, mag, p - mag)


def gaussian_rns(key, primes_arr, sigma: float, batch: int, n: int) -> jax.Array:
    """Discrete Gaussian (rounded continuous, sigma=3.2 default) as residues.

    Rounded-Gaussian is the standard practical replacement for an exact
    discrete Gaussian at these sigmas (reference spec
    ``docs/ARCHITECTURE.md:197-217``)."""
    g = jax.random.normal(key, (batch, n), dtype=jnp.float32) * sigma
    vals = jnp.round(g).astype(jnp.int32)
    return _small_signed_to_rns(vals, primes_arr)


def ternary_rns(key, primes_arr, batch: int, n: int,
                hamming_weight: int | None = None) -> jax.Array:
    """Ternary {-1, 0, 1} secret/encryption polynomial.

    With hamming_weight h: exactly h nonzero entries (+-1), the reference's
    declared spec (``include/fhe.cuh:20``, ``include/polynomial.cuh:129-135``).
    Without: uniform over {-1, 0, 1}."""
    if hamming_weight is None:
        v = jax.random.randint(key, (batch, n), -1, 2, dtype=jnp.int32)
        return _small_signed_to_rns(v, primes_arr)
    k_pos, k_sign = jax.random.split(key)
    # A uniform random h-subset via REJECTION-SAMPLED direct index draws:
    # draw h indices uniformly (n is a power of two, so randint has zero
    # modulo bias), redraw while any duplicate exists.  Conditioned on
    # distinctness the tuple is uniform over distinct tuples, so the
    # position SET is an exact uniform h-subset — the same distribution as
    # the previous argtop-h-of-iid-keys sampler, without a top-k over all
    # n positions: an h-draw + sort-of-h + one-hot sum, with
    # P(redraw) ~ 1-exp(-h^2/2n) ~ 22% at h=64, n=8192.
    h = hamming_weight

    def draw(k):
        idx = jax.random.randint(k, (batch, h), 0, n, dtype=jnp.int32)
        srt = jnp.sort(idx, axis=1)
        dup = jnp.any(srt[:, 1:] == srt[:, :-1])
        return idx, dup

    def cond(carry):
        _, bad, _ = carry
        return bad

    def body(carry):
        _, _, k = carry
        k, sub = jax.random.split(k)
        i, bad = draw(sub)
        return i, bad, k

    k0, kloop = jax.random.split(k_pos)
    idx0, bad0 = draw(k0)
    idx, _, _ = jax.lax.while_loop(cond, body, (idx0, bad0, kloop))
    signs = jax.random.rademacher(k_sign, (batch, hamming_weight),
                                  dtype=jnp.int32)
    # scatter-free construction: v[b, j] = sum_d signs[b, d] * [j == idx[b, d]]
    # (indices are distinct by construction, so sums never collide)
    onehot = (jnp.arange(n, dtype=jnp.int32)[None, None, :]
              == idx[:, :, None])                      # [batch, h, n]
    v = jnp.sum(jnp.where(onehot, signs[:, :, None], 0), axis=1,
                dtype=jnp.int32)
    return _small_signed_to_rns(v, primes_arr)


def uniform_mod_t_host(key, t: int, batch: int, n: int) -> jax.Array:
    """Uniform plaintext coefficients mod t (test helper)."""
    return jax.random.randint(key, (batch, n), 0, t, dtype=jnp.uint32)
