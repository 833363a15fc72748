"""Lane-sliced uint32 modular arithmetic — the word-size field layer.

This replaces the reference's L1+L2 (PTX carry chains + 256-bit Montgomery
CIOS, ``kernels/ptx_bigint.cuh:8-117``, ``include/bigint.cuh:27-161``): the RNS
prime basis *is* the bigint layer and every prime fits a uint32 lane.  All
functions here are pure jnp on uint32 values, so they run identically as
jitted elementwise ops on [k, batch, n] tensors on any backend, the CPU
tests included.

Modmul strategies (cost in 32-bit multiplies):
  * ``mul_mod_shoup``   — 3 muls + 1 mulhi: one operand is a precomputed
    constant (twiddles, CRT factors, inverse scalars).  Harvey's NTT trick;
    the workhorse of every butterfly.
  * ``mul_mod_barrett`` — both operands variable (pointwise ciphertext
    products, key-switch inner products).  Requires 2^29 < p < 2^30 so the
    Barrett constant mu = floor(2^61/p) fits uint32.
  * ``mul_mod_montgomery`` — REDC alternative kept for parity with the
    reference's Montgomery layer (``include/bigint.cuh:76-140``); same
    asymptotic cost as Barrett here.

All arithmetic relies on uint32 wraparound (mod 2^32) semantics.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# numpy scalars (not jnp arrays): they inline as literals in traced code
U32 = np.uint32
_MASK16 = np.uint32(0xFFFF)


def umul32_wide(a, b):
    """Full 64-bit product of uint32 values as (hi, lo) uint32 pair.

    Stand-in for PTX ``mul.lo.u64``/``mul.hi.u64``
    (``kernels/ptx_bigint.cuh:34-42``) built from uint32 ops only: a 16-bit
    limb decomposition, so no 64-bit type is needed anywhere.
    """
    a = a.astype(U32) if hasattr(a, "astype") else U32(a)
    b = b.astype(U32) if hasattr(b, "astype") else U32(b)
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    # mid terms: lh + hl + carry handling entirely in uint32
    mid = lh + (ll >> 16)            # <= (2^16-1)^2 + 2^16 - 1 < 2^32, no wrap
    mid2 = hl + (mid & _MASK16)      # same bound, no wrap
    hi = hh + (mid >> 16) + (mid2 >> 16)
    lo = a * b                       # natural wraparound low half
    return hi, lo


def umul32_hi(a, b):
    """High 32 bits of the 64-bit product."""
    return umul32_wide(a, b)[0]


def add_mod(a, b, p):
    """(a + b) mod p for a, b in [0, p), p < 2^31.

    Reference: device ``add_mod`` with conditional correction
    (``include/bigint.cuh:27-48``)."""
    s = a + b  # < 2^32, no wrap for p < 2^31
    return jnp.where(s >= p, s - p, s)


def sub_mod(a, b, p):
    """(a - b) mod p for a, b in [0, p) (reference ``include/bigint.cuh:50-73``)."""
    d = a - b  # wraps for a < b
    return jnp.where(a >= b, d, d + p)


def neg_mod(a, p):
    return jnp.where(a == 0, a, p - a)


# -- Shoup multiplication (constant operand) ---------------------------------


def shoup_precompute(w: int, p: int) -> int:
    """Host-side companion constant w' = floor(w * 2^32 / p)."""
    return (w << 32) // p


def mul_mod_shoup(x, w, w_shoup, p):
    """x*w mod p where (w, w_shoup) is a precomputed pair, any x < 2^32.

    r = x*w - floor(x*w'/2^32)*p in [0, 2p), then one conditional subtract.
    3 low muls + 1 mulhi — the cheapest exact modmul in uint32."""
    q = umul32_hi(x, w_shoup)
    r = x * w - q * p  # both mod 2^32; true value < 2p < 2^32
    return jnp.where(r >= p, r - p, r)


def reduce_mod_shoup(x, p, one_shoup):
    """x mod p for ANY uint32 x and any p < 2^31; one_shoup = floor(2^32/p).

    This is mul_mod_shoup with w = 1: r = x - floor(x*2^32/p / 2^32)*p lands
    in [0, 2p), one conditional subtract finishes.  The generic small-modulus
    reduction used by the arbitrary-t decryption path (the t = 65537 case has
    the cheaper Fermat fold, reduce_mod_fermat16)."""
    q = umul32_hi(x, one_shoup)
    r = x - q * p
    return jnp.where(r >= p, r - p, r)


def add_mod_tree(x, p, axis: int):
    """Reduce an axis by modular summation with a balanced tree (log2 depth).

    Replaces serial fold chains (e.g. the key-switch digit accumulation,
    reference relinearization spec docs/ARCHITECTURE.md:319-327) with a
    shape-halving sweep XLA fuses into a handful of full-width ops."""
    import jax.lax as lax

    while x.shape[axis] > 1:
        m = x.shape[axis]
        half = m // 2
        a = lax.slice_in_dim(x, 0, half, axis=axis)
        b = lax.slice_in_dim(x, half, 2 * half, axis=axis)
        s = add_mod(a, b, p)
        if m % 2:
            s = jnp.concatenate(
                [s, lax.slice_in_dim(x, 2 * half, m, axis=axis)], axis=axis)
        x = s
    return x


# -- Barrett multiplication (both operands variable) --------------------------


def barrett_precompute(p: int) -> int:
    """mu = floor(2^61 / p); requires 2^29 < p < 2^30 so mu < 2^32."""
    assert (1 << 29) < p < (1 << 30), f"Barrett layer needs 30-bit primes, got {p}"
    return (1 << 61) // p


def mul_mod_barrett(a, b, p, mu):
    """a*b mod p for a, b in [0, p), 2^29 < p < 2^30, mu = floor(2^61/p).

    q_hat = floor(floor(ab/2^29) * mu / 2^32) underestimates ab/p by < 2.5,
    so two conditional subtracts complete the reduction."""
    hi, lo = umul32_wide(a, b)
    s = (hi << 3) | (lo >> 29)           # floor(ab / 2^29), < 2^31
    qh = umul32_hi(s, mu)
    r = lo - qh * p                      # true remainder < 2.5p < 2^32
    two_p = p + p
    r = jnp.where(r >= two_p, r - two_p, r)
    return jnp.where(r >= p, r - p, r)


def reduce_u64_mod(hi, lo, p, mu, two32_mod_p):
    """(hi*2^32 + lo) mod p for arbitrary uint32 hi/lo.

    Used by the samplers to turn 64 random bits into an (almost) unbiased
    residue (bias < 2^-34).  two32_mod_p = 2^32 mod p (precomputed)."""
    hi_red = barrett_reduce_u32(hi, p, mu)
    lo_red = barrett_reduce_u32(lo, p, mu)
    return add_mod(mul_mod_barrett(hi_red, two32_mod_p, p, mu), lo_red, p)


def barrett_reduce_u32(x, p, mu):
    """x mod p for any uint32 x (p in (2^29, 2^30))."""
    s = x >> 29
    qh = umul32_hi(s, mu)
    r = x - qh * p
    two_p = p + p
    r = jnp.where(r >= two_p, r - two_p, r)
    return jnp.where(r >= p, r - p, r)


# -- Montgomery (REDC) --------------------------------------------------------


def montgomery_precompute(p: int) -> tuple[int, int, int]:
    """(p_neg_inv = -p^-1 mod 2^32, r2 = 2^64 mod p, r1 = 2^32 mod p).

    Replaces the host Newton iteration of the reference
    (``src/bigint.cu:23-40``, whose r_squared was a placeholder 1)."""
    p_inv = pow(p, -1, 1 << 32)
    return ((1 << 32) - p_inv) % (1 << 32), (1 << 64) % p, (1 << 32) % p


def mul_mod_montgomery(a, b, p, p_neg_inv):
    """REDC(a*b) = a*b*2^-32 mod p, inputs in [0, p), p < 2^31.

    Counterpart of the reference CIOS loop (``include/bigint.cuh:76-140``)."""
    hi, lo = umul32_wide(a, b)
    m = lo * p_neg_inv                   # mod 2^32
    mp_hi, mp_lo = umul32_wide(m, p)
    # lo + mp_lo == 0 mod 2^32 by construction; carry out iff lo != 0
    carry = jnp.where(lo != U32(0), U32(1), U32(0))
    t = hi + mp_hi + carry               # < 2p for p < 2^31
    return jnp.where(t >= p, t - p, t)


def pow_mod(base, exp: int, p, mu):
    """Square-and-multiply with a *host* exponent (static under jit).

    Reference ``pow_mod`` (``include/bigint.cuh:143-161``)."""
    result = jnp.full_like(base, U32(1))
    acc = base
    e = int(exp)
    while e:
        if e & 1:
            result = mul_mod_barrett(result, acc, p, mu)
        acc = mul_mod_barrett(acc, acc, p, mu)
        e >>= 1
    return result


def mul_mod_var(a, b, p, one_shoup, two32_mod_p, two32_shoup):
    """a*b mod p for VARIABLE a, b in [0, p), any p < 2^29.

    No Barrett constant needed (Barrett here requires 30-bit moduli): split
    the 64-bit product, reduce both halves with the Shoup w=1 trick, and
    recombine through the precomputed constant 2^32 mod p.  Used for
    device-traced mod-t arithmetic (e.g. the BGV scale_t correction chain).

    one_shoup = floor(2^32/p); two32_mod_p = 2^32 mod p with its Shoup
    companion two32_shoup — all host-precomputable from p alone."""
    hi, lo = umul32_wide(a, b)
    hi_r = reduce_mod_shoup(hi, p, one_shoup)
    lo_r = reduce_mod_shoup(lo, p, one_shoup)
    hi_c = mul_mod_shoup(hi_r, two32_mod_p, two32_shoup, p)
    return add_mod(hi_c, lo_r, p)


def pow_mod_var(base, exp: int, p, one_shoup, two32_mod_p, two32_shoup):
    """base^exp mod p with a static host exponent, via mul_mod_var (for
    small moduli where the Barrett pow_mod does not apply).  Used for
    device-side modular inverses mod prime t: exp = t - 2 (Fermat)."""
    result = jnp.full_like(base, U32(1))
    acc = base
    e = int(exp)
    while e:
        if e & 1:
            result = mul_mod_var(result, acc, p, one_shoup, two32_mod_p,
                                 two32_shoup)
        acc = mul_mod_var(acc, acc, p, one_shoup, two32_mod_p, two32_shoup)
        e >>= 1
    return result


# -- Fermat-prime fast path for t = 65537 -------------------------------------


def reduce_mod_fermat16(x):
    """Any uint32 x mod 65537, via 2^16 = -1 (mod t): x = lo - hi."""
    t = U32(65537)
    r = (x & U32(0xFFFF)) + t - (x >> 16)  # hi < 2^16 <= t so this is >= 1
    return jnp.where(r >= t, r - t, r)


def mul_mod_fermat16(a, b):
    """a*b mod 65537 using 2^16 = -1 (mod t); inputs in [0, 65537).

    Used by the BatchEncoder's mod-t NTT (slot packing); one wide mul and a
    fold, no Barrett constant needed."""
    t = U32(65537)
    hi, lo = umul32_wide(a, b)
    # value = hi*2^32 + lo and 2^32 = (2^16)^2 = 1 (mod t), so value = hi + lo.
    s = reduce_mod_fermat16(hi) + reduce_mod_fermat16(lo)
    return jnp.where(s >= t, s - t, s)
