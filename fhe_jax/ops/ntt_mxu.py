"""Four-step negacyclic NTT as modular *matrix multiplications* (opt-in,
``make_context(use_mxu=True)``).

The four-step decomposition turns the length-n transform into
length-n1/n2 transforms applied as dense [n1,n1]/[n2,n2] matrix products
(n1 = 128 tiles) at O(n·(n1+n2)) multiply-adds instead of O(n log n)
butterflies.  Each modular product is an int8 ``einsum`` with int32
accumulation, a shape XLA can hand to int8 matrix units.  It is plain
``jax.numpy``: whether it beats the stage-sweep engine (ops/ntt.py) on a
given device is a measurement, not a property of the code.

Derivation (ψ = 2n-th root, ω = ψ², twist folded in):
    i = i1 + n1·i2,  j = j2 + n2·j1
    X[j1, j2] = Σ_{i1} W[j1,i1] · T[i1,j2] · Σ_{i2} M[i1,i2] · V[i2,j2]
with
    M[i1,i2] = x_{i1 + n1·i2}
    V[i2,j2] = ψ^{n1·i2} · ω^{n1·i2·j2}      (row transform + twist part 2)
    T[i1,j2] = ψ^{i1} · ω^{i1·j2}            (mid twiddles + twist part 1)
    W[j1,i1] = ω^{n2·i1·j1}                  (column transform)
i.e.  X = W @ ((M @ V) ⊙ T), all mod p.  The output is the natural-order
negacyclic NTT in [j1, j2] layout (j = j2 + n2·j1) — a *different* order
from the merged-ψ CT engine (bit-reversed); forward/pointwise/inverse here
are self-consistent, and the polymul result is order-independent
(tests cross-check against ops/ntt.polymul_negacyclic bit-exactly).

Modular matmul on int8 matrix units: operands < 2^30 are split into FOUR
balanced signed base-256 digits d_i ∈ [-128, 127] (x = Σ d_i·256^i, the
int8-native radix — signed int8 operands need no offset), giving 16
limb-pair int8 matmuls accumulated in int32 instead of the 25 that five
unsigned 7-bit limbs would need (36% fewer matmuls).  Per-diagonal dot
bounds: |pair product| ≤ 128², the worst diagonal (s = 3, four pairs with
the ≤64 top digit) sums to ≤ 49152·n2, int32-safe through n2 ≤ 4096
(enforced in build_mxu_tables).  Recombination adds the static offset
OFF = 49152·n2 to each signed diagonal (making it a reduced residue,
2·OFF < p), runs a base-256 Horner sweep mod p elementwise, and subtracts
the precomputed OFF·Σ_s 256^s mod p correction once at the end.

This realizes the reference's "Tensor Core Acceleration" future-work item.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .. import primes as _primes
from ..utils import struct
from . import modmath as mm

_U = np.uint32
_LIMBS = 4
_BASE_BITS = 8
_BASE = 1 << _BASE_BITS          # 256
_MASK = _BASE - 1
_HALF = _BASE // 2               # digits >= 128 borrow: d -> d - 256, carry +1
# worst |diagonal| per unit of contraction length: s = 3 pairs
# (0,3)+(1,2)+(2,1)+(3,0) with digit bounds [128,128,128,64] on both sides
_DIAG_BOUND = 128 * 64 + 128 * 128 + 128 * 128 + 64 * 128  # = 49152


@struct.dataclass
class MXUNTTTables:
    """Per-prime four-step constants.  n = n1 * n2, n1/n2 powers of two
    (static fields, so the tables can ride inside a jitted context pytree).

    Matrix limb tensors are int8 [k, LIMBS, dim, dim]; twiddle tables are
    uint32 [k, n1, n2] with Shoup companions."""

    p: jax.Array             # [k]
    mu: jax.Array            # [k] Barrett
    horner_corr: jax.Array   # [k] OFF * sum_s 256^s mod p (signed-digit offset)
    n1: int = struct.field(pytree_node=False)
    n2: int = struct.field(pytree_node=False)
    v_limbs: jax.Array       # [k, L, n2, n2] int8   (fwd row matrix V)
    w_limbs: jax.Array       # [k, L, n1, n1] int8   (fwd col matrix W)
    t_mid: jax.Array         # [k, n1, n2] u32       (fwd mid twiddles T)
    t_mid_shoup: jax.Array
    vi_limbs: jax.Array      # inverse counterparts (n^-1 folded into Vi)
    wi_limbs: jax.Array
    ti_mid: jax.Array
    ti_mid_shoup: jax.Array


def _limbs_host(mat: np.ndarray) -> np.ndarray:
    """uint32 [.., m, n] -> int8 [L, .., m, n] balanced signed base-256
    digits: d_i in [-128, 127] for i < 3, top digit in [0, 64] for
    values < 2^30 (the borrow carry adds at most 1).

    The < 2^30 precondition is NOT just about limb count: _DIAG_BOUND bakes
    in the top-digit <= 64 bound, so a value in [2^30, 2^32) would decompose
    without a leftover carry yet silently break the Horner offset
    (|Q_3| could reach 65536*L > OFF).  Enforce the real bound here."""
    assert (mat < (1 << 30)).all(), \
        "entry >= 2^30: top signed digit would exceed the 64 bound baked " \
        "into _DIAG_BOUND (silent Horner-offset wraparound)"
    out = []
    v = mat.astype(np.int64)
    for _ in range(_LIMBS):
        d = v & _MASK
        borrow = d >= _HALF
        out.append((d - (borrow.astype(np.int64) << _BASE_BITS)).astype(np.int8))
        v = (v >> _BASE_BITS) + borrow
    assert not v.any(), "leftover carry after all limbs"
    return np.stack(out)


@functools.lru_cache(maxsize=None)
def _build_host(n: int, n1: int, prime_tuple: tuple[int, ...]):
    n2 = n // n1
    rows = {f: [] for f in ("v", "w", "t", "ts", "vi", "wi", "ti", "tis")}
    for p in prime_tuple:
        psi = _primes.negacyclic_psi(n, p)
        w_root = pow(psi, 2, p)
        ipsi = pow(psi, -1, p)
        iw = pow(w_root, -1, p)
        n_inv = pow(n, -1, p)

        # V[i2, j2] = psi^{n1 i2} * w^{n1 i2 j2}  (contraction index i2 first)
        v = np.empty((n2, n2), dtype=object)
        for a in range(n2):
            rb = pow(w_root, n1 * a, p)
            ex = pow(psi, n1 * a, p)
            acc = ex
            for b in range(n2):
                v[a, b] = acc
                acc = acc * rb % p
        v = v.astype(np.uint64).astype(_U)

        # T[i1, j2] = psi^{i1} * w^{i1 j2}
        t = np.empty((n1, n2), dtype=object)
        for a in range(n1):
            rb = pow(w_root, a, p)
            acc = pow(psi, a, p)
            for b in range(n2):
                t[a, b] = acc
                acc = acc * rb % p
        t = t.astype(np.uint64).astype(_U)

        # W[j1, i1] = w^{n2 i1 j1}
        wm = np.empty((n1, n1), dtype=object)
        for a in range(n1):
            rb = pow(w_root, n2 * a, p)
            acc = 1
            for b in range(n1):
                wm[a, b] = acc
                acc = acc * rb % p
        wm = wm.astype(np.uint64).astype(_U)

        # Inverse: x = (1/n) * conj-transform.  M = Vi @ ((Wi @ X) ⊙ Ti) with
        #   Wi[i1, j1] = w^{-n2 i1 j1}
        #   Ti[i1, j2] = psi^{-i1} * w^{-i1 j2}
        #   Vi[j2', i2... ] — row inverse with twist removal and n^-1 folded:
        #   x[i1, i2] = n^-1 * psi^{-n1 i2} * Σ_{j2} w^{-n1 i2 j2} * Y[i1, j2]
        wi = np.empty((n1, n1), dtype=object)
        for a in range(n1):
            rb = pow(iw, n2 * a, p)
            acc = 1
            for b in range(n1):
                wi[a, b] = acc
                acc = acc * rb % p
        wi = wi.astype(np.uint64).astype(_U)

        ti = np.empty((n1, n2), dtype=object)
        for a in range(n1):
            rb = pow(iw, a, p)
            acc = pow(ipsi, a, p)
            for b in range(n2):
                ti[a, b] = acc
                acc = acc * rb % p
        ti = ti.astype(np.uint64).astype(_U)

        # Vi applied as A @ Vi (contraction over j2), so store [j2_in, i2_out]:
        # Vi[j2, i2] = n^-1 * psi^{-n1 i2} * w^{-n1 i2 j2}
        vi = np.empty((n2, n2), dtype=object)
        for a in range(n2):  # output index i2 (column)
            rb = pow(iw, n1 * a, p)
            acc = n_inv * pow(ipsi, n1 * a, p) % p
            for b in range(n2):  # input index j2 (row)
                vi[b, a] = acc
                acc = acc * rb % p
        vi = vi.astype(np.uint64).astype(_U)

        def shoup_row(tbl):
            flat = [mm.shoup_precompute(int(x), p) for x in tbl.reshape(-1)]
            return np.array(flat, dtype=_U).reshape(tbl.shape)

        rows["v"].append(_limbs_host(v))
        rows["w"].append(_limbs_host(wm))
        rows["t"].append(t)
        rows["ts"].append(shoup_row(t))
        rows["vi"].append(_limbs_host(vi))
        rows["wi"].append(_limbs_host(wi))
        rows["ti"].append(ti)
        rows["tis"].append(shoup_row(ti))
    return {k2: np.stack(vv) for k2, vv in rows.items()}


def build_mxu_tables(n: int, primes_list, n1: int | None = None) -> MXUNTTTables:
    if n1 is None:
        n1 = 128 if n >= 16384 else max(64, min(128, 1 << ((n.bit_length() - 1) // 2)))
    primes_t = tuple(int(p) for p in primes_list)
    n2 = n // n1
    # Signed-digit bound: the worst diagonal |Q_3| <= 49152*L (L = the
    # contraction length, n2 for the V matmul / n1 for W) must satisfy
    # 2*OFF = 2*49152*max(n1,n2) < p (so the offset diagonal is a reduced
    # residue); p > 2^29 gives max(n1,n2) <= 4096 with margin
    # (2*49152*4096 = 2^28.6).
    if 2 * _DIAG_BOUND * max(n1, n2) >= (1 << 29):
        raise ValueError(
            f"contraction length max(n1,n2) = {max(n1, n2)} overflows the "
            f"signed-digit diagonal offset (max 4096) for n = {n}")
    for p in primes_t:
        if not (1 << 29) < p < (1 << 30):
            raise ValueError(f"MXU engine needs 30-bit primes, got {p}")
    host = _build_host(n, n1, primes_t)
    off = _DIAG_BOUND * max(n1, n2)
    geo = sum(_BASE ** s for s in range(2 * _LIMBS - 1))
    return MXUNTTTables(
        p=jnp.asarray(np.array(primes_t, dtype=_U)),
        mu=jnp.asarray(np.array([mm.barrett_precompute(p) for p in primes_t],
                                dtype=_U)),
        horner_corr=jnp.asarray(np.array([off * geo % p for p in primes_t],
                                         dtype=_U)),
        n1=n1, n2=n2,
        v_limbs=jnp.asarray(host["v"]),
        w_limbs=jnp.asarray(host["w"]),
        t_mid=jnp.asarray(host["t"]),
        t_mid_shoup=jnp.asarray(host["ts"]),
        vi_limbs=jnp.asarray(host["vi"]),
        wi_limbs=jnp.asarray(host["wi"]),
        ti_mid=jnp.asarray(host["ti"]),
        ti_mid_shoup=jnp.asarray(host["tis"]),
    )


def slice_tables(tb: MXUNTTTables, k: int) -> MXUNTTTables:
    """First-k-primes view (leveled transforms); n1/n2 are static."""
    return MXUNTTTables(
        p=tb.p[:k], mu=tb.mu[:k], horner_corr=tb.horner_corr[:k],
        n1=tb.n1, n2=tb.n2,
        v_limbs=tb.v_limbs[:k], w_limbs=tb.w_limbs[:k],
        t_mid=tb.t_mid[:k], t_mid_shoup=tb.t_mid_shoup[:k],
        vi_limbs=tb.vi_limbs[:k], wi_limbs=tb.wi_limbs[:k],
        ti_mid=tb.ti_mid[:k], ti_mid_shoup=tb.ti_mid_shoup[:k],
    )


def slice_tables_last(tb: MXUNTTTables, k: int) -> MXUNTTTables:
    """Last-k-primes view (leveled BEHZ Bsk base — see ntt.slice_tables_last)."""
    return MXUNTTTables(
        p=tb.p[-k:], mu=tb.mu[-k:], horner_corr=tb.horner_corr[-k:],
        n1=tb.n1, n2=tb.n2,
        v_limbs=tb.v_limbs[-k:], w_limbs=tb.w_limbs[-k:],
        t_mid=tb.t_mid[-k:], t_mid_shoup=tb.t_mid_shoup[-k:],
        vi_limbs=tb.vi_limbs[-k:], wi_limbs=tb.wi_limbs[-k:],
        ti_mid=tb.ti_mid[-k:], ti_mid_shoup=tb.ti_mid_shoup[-k:],
    )


# ---------------------------------------------------------------------------
# modular matmul via int8 limb decomposition
# ---------------------------------------------------------------------------


def _data_limbs(x: jax.Array) -> jax.Array:
    """uint32 [..] -> int8 [L, ..] balanced signed base-256 digits
    (see _limbs_host; values < 2^30, top digit lands in [0, 64]).

    PRECONDITION (unchecked — traced): every entry must be a fully reduced
    residue < p < 2^30.  Values in [2^30, 2^32) decompose into a top digit
    up to 128, exceeding the <= 64 bound in _DIAG_BOUND, and the Horner
    offset uint32 cast wraps — silent corruption, no error.  Do NOT feed
    lazy-reduction ([0, 2p)) values without a reduce first."""
    outs = []
    v = x
    for _ in range(_LIMBS):
        d = v & jnp.uint32(_MASK)
        borrow = (d >= jnp.uint32(_HALF)).astype(jnp.uint32)
        outs.append((d.astype(jnp.int32)
                     - (borrow << _BASE_BITS).astype(jnp.int32)).astype(jnp.int8))
        v = (v >> _BASE_BITS) + borrow
    return jnp.stack(outs)


def _horner_mod(qs, p, mu, corr, contraction_bound: int):
    """Σ_s 256^s * Q_s mod p for SIGNED int32 diagonals
    |Q_s| <= 49152 * contraction_bound.

    Each diagonal is shifted by the static OFF = 49152*max(n1,n2) (< p/2,
    enforced in build_mxu_tables), making it a non-negative reduced residue
    with no Barrett pass, then a base-256 Horner sweep accumulates mod p and
    the precomputed OFF·Σ_s 256^s mod p correction is subtracted once."""
    off = jnp.int32(_DIAG_BOUND * contraction_bound)
    shifted = [(q + off).astype(jnp.uint32) for q in qs]  # < 2*OFF < p
    base = jnp.uint32(_BASE)
    r = shifted[-1]
    for u in range(len(shifted) - 2, -1, -1):
        r = mm.add_mod(
            mm.mul_mod_barrett(r, jnp.broadcast_to(base, r.shape), p, mu),
            shifted[u], p)
    return mm.sub_mod(r, corr, p)


def _matmul_mod(x: jax.Array, mat_limbs: jax.Array, p, mu, corr,
                contraction_bound: int, side: str) -> jax.Array:
    """Modular matmul on the last-two axes of x [k, B, m, n].

    side='right': x @ M  with mat_limbs [k, L, n, n']
    side='left' : M @ x  with mat_limbs [k, L, m', m]
    """
    xl = _data_limbs(x)  # [L, k, B, m, n]
    n_diag = 2 * _LIMBS - 1
    qs = [None] * n_diag
    for a in range(_LIMBS):
        for b in range(_LIMBS):
            if side == "right":
                c = jnp.einsum("kbmn,knj->kbmj", xl[a], mat_limbs[:, b],
                               preferred_element_type=jnp.int32)
            else:
                c = jnp.einsum("kim,kbmn->kbin", mat_limbs[:, b], xl[a],
                               preferred_element_type=jnp.int32)
            s = a + b
            qs[s] = c if qs[s] is None else qs[s] + c
    return _horner_mod(qs, p, mu, corr, contraction_bound)


def ntt_forward(x: jax.Array, tb: MXUNTTTables) -> jax.Array:
    """[k, B, n] -> [k, B, n] natural-order four-step negacyclic NTT
    (output index j = j2 + n2*j1 stored flat)."""
    k, bt, n = x.shape
    n1, n2 = tb.n1, tb.n2
    p = tb.p[:, None, None, None]
    mu = tb.mu[:, None, None, None]
    corr = tb.horner_corr[:, None, None, None]
    lmax = max(n1, n2)
    # M[i1, i2]: x index i1 + n1*i2 -> reshape [i2, i1] then transpose
    m = x.reshape(k, bt, n2, n1).transpose(0, 1, 3, 2)      # [k,B,n1,n2]
    a = _matmul_mod(m, tb.v_limbs, p, mu, corr, lmax, side="right")
    a = mm.mul_mod_shoup(a, tb.t_mid[:, None], tb.t_mid_shoup[:, None],
                         tb.p[:, None, None, None])
    out = _matmul_mod(a, tb.w_limbs, p, mu, corr, lmax, side="left")
    # out[j1, j2], flat j = j2 + n2*j1 -> reshape directly
    return out.reshape(k, bt, n)


def ntt_inverse(y: jax.Array, tb: MXUNTTTables) -> jax.Array:
    """Inverse of ntt_forward (natural four-step order in, coeffs out)."""
    k, bt, n = y.shape
    n1, n2 = tb.n1, tb.n2
    p = tb.p[:, None, None, None]
    mu = tb.mu[:, None, None, None]
    corr = tb.horner_corr[:, None, None, None]
    lmax = max(n1, n2)
    x = y.reshape(k, bt, n1, n2)                             # [j1, j2]
    a = _matmul_mod(x, tb.wi_limbs, p, mu, corr, lmax, side="left")
    a = mm.mul_mod_shoup(a, tb.ti_mid[:, None], tb.ti_mid_shoup[:, None],
                         tb.p[:, None, None, None])
    m = _matmul_mod(a, tb.vi_limbs, p, mu, corr, lmax, side="right")
    # m[i1, i2] -> flat i = i1 + n1*i2
    return m.transpose(0, 1, 3, 2).reshape(k, bt, n)


def pointwise_mul(a: jax.Array, b: jax.Array, tb: MXUNTTTables) -> jax.Array:
    return mm.mul_mod_barrett(a, b, tb.p[:, None, None], tb.mu[:, None, None])


def polymul_negacyclic(a: jax.Array, b: jax.Array, tb: MXUNTTTables) -> jax.Array:
    """Negacyclic polymul entirely on the MXU path; bit-exact with
    ops/ntt.polymul_negacyclic."""
    fa = ntt_forward(a, tb)
    fb = ntt_forward(b, tb)
    return ntt_inverse(pointwise_mul(fa, fb, tb), tb)
