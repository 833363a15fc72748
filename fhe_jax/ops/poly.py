"""Polynomial-ring ops over Z_q[x]/(x^n + 1) — the L4 layer.

Counterpart of the reference's ``Polynomial``/``PolynomialOps``
(``include/polynomial.cuh:10-59``, ``src/polynomial.cu``): polynomials are
plain ``[k, batch, n]`` uint32 residue tensors (no RAII device buffers — XLA
owns memory), and every op is a pure jittable function.  Includes the
reference's *declared-only* members (``include/polynomial.cuh:29-45``):
``mul`` / ``mul_negacyclic`` (schoolbook negacyclic product), ``add_scalar``,
``mod_switch`` (⌊q'/q · x⌉ rescale), ``estimate_noise`` (centered ∞-norm,
spec ``compute_noise_norm_kernel`` :138-143) and ``negacyclic_reduce``
(:105-109).

All inputs are residues in [0, p) per prime; ``tb`` is an
``fhe_jax.ops.ntt.NTTTables`` (carrying p and Barrett mu).

This module is the single implementation of coefficient-domain ring
arithmetic: the scheme layer (scheme/bfv.py add/sub/±plain, scheme/bgv.py
t-scaling and plain ops) routes through these functions rather than calling
modmath directly, so ring-op semantics live in exactly one place (round-1
review item 9).  NTT-domain pointwise ops stay in ops/ntt (they are
evaluation-domain, not ring-domain, semantics).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import modmath as mm
from . import ntt as _ntt


def _p3(tb):
    return tb.p[:, None, None]


def add(a: jax.Array, b: jax.Array, tb) -> jax.Array:
    """Coefficient-wise sum (reference ``poly_add_kernel``,
    ``src/polynomial.cu:70-79``)."""
    return mm.add_mod(a, b, _p3(tb))


def sub(a: jax.Array, b: jax.Array, tb) -> jax.Array:
    """Coefficient-wise difference (``poly_sub_kernel``, :81-90)."""
    return mm.sub_mod(a, b, _p3(tb))


def _scalar_residues(scalar, tb) -> jax.Array:
    """python int -> [k] residues mod tb.p.

    Host path (tb.p concrete): exact per-prime reduction of ANY python int
    (negatives and multi-prime products included).  Traced path (inside a
    jit where tb.p is a tracer): a device-side remainder over k scalars,
    which requires the scalar to fit uint32."""
    if isinstance(scalar, (int, np.integer)):
        v = int(scalar)
        if not isinstance(tb.p, jax.core.Tracer):
            return jnp.asarray(
                [v % int(p) for p in np.asarray(tb.p)], jnp.uint32)
        if 0 <= v < (1 << 32):
            return jnp.mod(jnp.full_like(tb.p, np.uint32(v)), tb.p)
        raise ValueError(
            f"scalar {v} does not fit uint32 and the prime table is traced; "
            "reduce it per prime on the host first")
    return scalar


def mul_scalar(a: jax.Array, scalar, tb) -> jax.Array:
    """a * c mod p per prime (``poly_mul_scalar_kernel``, :98-111).

    scalar: python int (reduced per prime) or [k] array of residues."""
    s = _scalar_residues(scalar, tb)
    return mm.mul_mod_barrett(a, s[:, None, None], _p3(tb),
                              tb.mu[:, None, None])


def add_scalar(a: jax.Array, scalar, tb) -> jax.Array:
    """a + c mod p (declared-only ``poly_add_scalar_kernel``,
    ``include/polynomial.cuh:87-93``) — added to the constant coefficient of
    every polynomial? No: the reference's elementwise contract adds c to
    every coefficient, matching its batch kernels; we mirror that."""
    s = _scalar_residues(scalar, tb)
    return mm.add_mod(a, s[:, None, None], _p3(tb))


def mul_ntt(a: jax.Array, b: jax.Array, tb) -> jax.Array:
    """Negacyclic product via NTT (``PolynomialOps::mul_ntt``,
    ``src/polynomial.cu:54-58``)."""
    return _ntt.polymul_negacyclic(a, b, tb)


def mul_negacyclic(a: jax.Array, b: jax.Array, tb) -> jax.Array:
    """O(n^2) schoolbook negacyclic product (declared-only ``mul_negacyclic``,
    ``include/polynomial.cuh:33``) — the exact-by-construction cross-check for
    mul_ntt; use only for tests/small n."""
    k, bt, n = a.shape
    # c[j] = sum_{i<=j} a_i b_{j-i} - sum_{i>j} a_i b_{n+j-i}
    idx = (jnp.arange(n)[:, None] - jnp.arange(n)[None, :]) % n  # [j, i] -> j-i
    sign_neg = jnp.arange(n)[None, :] > jnp.arange(n)[:, None]   # i > j wraps
    p = tb.p[:, None, None, None]
    mu = tb.mu[:, None, None, None]
    bi = b[:, :, None, :]                                # [k, bt, 1, i]
    aj = jnp.take(a, idx.reshape(-1), axis=2).reshape(k, bt, n, n)  # a[j-i]
    prod = mm.mul_mod_barrett(aj, bi, p, mu)             # [k, bt, j, i]
    prod = jnp.where(sign_neg[None, None], mm.neg_mod(prod, p), prod)
    # sum over i with mod reduction via float-free pairwise adds
    def body(carry, x):
        return mm.add_mod(carry, x, p[..., 0]), None
    acc = jnp.zeros((k, bt, n), jnp.uint32)
    acc, _ = jax.lax.scan(body, acc, jnp.moveaxis(prod, 3, 0))
    return acc


def negacyclic_reduce(coeffs2n: jax.Array, tb) -> jax.Array:
    """Reduce a [k, B, 2n] raw product mod (x^n + 1): c_i - c_{n+i}
    (declared-only ``negacyclic_reduce_kernel``,
    ``include/polynomial.cuh:105-109``)."""
    n = coeffs2n.shape[-1] // 2
    lo = coeffs2n[..., :n]
    hi = coeffs2n[..., n:]
    return mm.sub_mod(lo, hi, _p3(tb))


def mod_switch(a: jax.Array, tb_from, tb_to, mc) -> jax.Array:
    """⌊q'/q · a⌉ exact RNS rescale — the declared-only
    ``poly_mod_switch_kernel`` (``include/polynomial.cuh:96-102``; the
    reference *calls* it at ``src/fhe.cu:182`` without ever defining it).
    Delegates to the scheme-level drop-last-prime implementation
    (ops/rns.mod_switch_drop_last); mc = rns.make_mod_switch(primes)."""
    from . import rns as _rns
    return _rns.mod_switch_drop_last(a, mc)


def estimate_noise(a: jax.Array, tb, q_primes: tuple[int, ...]) -> jax.Array:
    """Centered infinity norm, log2: the declared-only ``estimate_noise`` /
    ``compute_noise_norm_kernel`` (``include/polynomial.cuh:45,138-143``).

    For a single-prime residue stack this is exact; for multi-prime it bounds
    per-residue magnitudes (scheme-level noise budget uses the exact
    gamma-trick path in scheme/bfv.estimate_noise_budget instead)."""
    p = tb.p[:, None, None]
    half = p // jnp.uint32(2)
    mag = jnp.where(a > half, p - a, a)
    return jnp.log2(jnp.maximum(jnp.max(mag.astype(jnp.float32)), 1.0))
