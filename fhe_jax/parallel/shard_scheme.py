"""Explicit shard_map BEHZ multiply + relinearize over the RNS prime axis.

The auto-partitioned path (parallel/sharded.py) places the prime axis and
lets GSPMD pick collectives.  This module is the *explicit* distributed
scheme path the SURVEY §2 parallelism table promises (reference design:
``docs/ARCHITECTURE.md:499-511`` — one prime per GPU, NVLink exchanges for
CRT): every cross-prime data movement is a named JAX collective inside a
``shard_map``, so the communication volume is exact, auditable from compiled
HLO (tests/test_shard_scheme.py asserts the collective op counts).

Data layout under the mesh axis ``rns`` (P devices, k = len(q_primes)):

  * q-base residue tensors ``[k, c, n]``       -> rows sharded, k % P == 0
  * Bsk-base tensors ``[kb, c, n]``            -> rows padded to kb_pad =
    ceil(kb/P)*P by duplicating the m_sk row (padded rows compute valid but
    unused arithmetic), then sharded
  * key material ``[k_prime, k_digit, 2, n]``  -> prime axis sharded
  * NTT twiddle tables                         -> prime-major rows sharded,
    so per-device table memory shrinks 1/P

Collectives per multiply+relin (the full inventory — nothing else moves):

  1. ``all_gather`` of the SmMRq digits of both operands   [k, 4, n]
  2. ``all_gather`` of the FastFloor conversion digits     [k, 3, n]
  3. ``all_gather`` of the floored Bsk rows (Shenoy-K.)    [kb_pad, 3, n]
  4. ``all_gather`` of the relin gadget digits             [k, 1, n]

The per-prime NTTs, tensor products, and the key-switch inner product run
entirely device-local (the reference's "each RNS component uses a separate
CUDA stream", ``docs/ARCHITECTURE.md:182``, mapped to devices).  An alternative
key switch that reduces the inner product with ``psum`` instead of gathering
digits is provided (``keyswitch_delta_psum``) for the collective-cost
comparison: it moves 4*k*n u32 lanes per direction (two 16-bit-split
all-reduces of [k, 2, n]) versus the gather's k*n, and needs the full
twiddle tables on every device — the gather strategy is the production
default, the psum strategy documents why.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import modmath as mm
from ..ops import ntt as _ntt
from ..scheme import noise as _noise
from ..scheme.types import Ciphertext, RelinKeys

_U = np.uint32
_MASK16 = np.uint32(0xFFFF)


# ---------------------------------------------------------------------------
# constant bundles (built host-side from the SchemeContext, then sharded)
# ---------------------------------------------------------------------------


class _QConsts(NamedTuple):
    """Per-q-prime constants: every leaf has leading dim k (sharded on rns)."""

    mt_inv_phat: jax.Array        # [k]   SmMRq digit scale (m_tilde folded)
    mt_inv_phat_sh: jax.Array
    floor_inv_phat: jax.Array     # [k]   FastFloor conv digit scale
    floor_inv_phat_sh: jax.Array
    inv_qhat: jax.Array           # [k]   relin gadget digit scale
    inv_qhat_sh: jax.Array
    sk_phat: jax.Array            # [k, l]  (B/b_i) mod q_j   (SK -> q rows)
    sk_phat_sh: jax.Array
    sk_bmod: jax.Array            # [k]   B mod q_j
    sk_bmod_sh: jax.Array


class _BskConsts(NamedTuple):
    """Per-Bsk-prime constants, padded to kb_pad rows (sharded on rns)."""

    p: jax.Array                  # [kb_pad]
    smq_phat: jax.Array           # [kb_pad, k]  (q/q_i) mod c_j
    smq_phat_sh: jax.Array
    smq_qmod: jax.Array           # [kb_pad]  q mod c_j
    smq_qmod_sh: jax.Array
    smq_inv_mt: jax.Array         # [kb_pad]  m_tilde^-1 mod c_j
    smq_inv_mt_sh: jax.Array
    floor_phat: jax.Array         # [kb_pad, k]
    floor_phat_sh: jax.Array
    floor_inv_q: jax.Array        # [kb_pad]  q^-1 mod c_j
    floor_inv_q_sh: jax.Array


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """Pad the leading axis to `rows` by repeating the last row (the m_sk
    row): padded lanes run valid modular arithmetic whose results are
    discarded after the gather — shard_map needs equal shard shapes."""
    pad = rows - arr.shape[0]
    if pad == 0:
        return arr
    return np.concatenate([arr] + [arr[-1:]] * pad, axis=0)


def build_plan(ctx, n_devices: int, level: int = 0):
    """Precompute the sharded-constant bundles for one level.  Cached per
    (params, n_devices, level) on the context object itself."""
    cache = getattr(ctx, "_shard_plan_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(ctx, "_shard_plan_cache", cache)
    if (n_devices, level) in cache:
        return cache[(n_devices, level)]
    kk = ctx.k - level
    if kk % n_devices:
        raise ValueError(
            f"explicit rns sharding needs (k - level) % P == 0 "
            f"(k={ctx.k}, level={level}, P={n_devices})")
    kb = ctx.bsk_counts[level]
    kb_pad = -(-kb // n_devices) * n_devices
    smq = ctx.smq_levels[level]
    fc = ctx.floor_levels[level]
    skc = ctx.sk_levels[level]
    inv_qhat, inv_qhat_sh = ctx.inv_qhat_levels[level]

    qc = _QConsts(
        mt_inv_phat=smq.mt_times_inv_phat,
        mt_inv_phat_sh=smq.mt_times_inv_phat_shoup,
        floor_inv_phat=fc.conv.inv_phat,
        floor_inv_phat_sh=fc.conv.inv_phat_shoup,
        inv_qhat=inv_qhat,
        inv_qhat_sh=inv_qhat_sh,
        sk_phat=skc.conv_q.phat_mod_dst,
        sk_phat_sh=skc.conv_q.phat_shoup_dst,
        sk_bmod=skc.B_mod_q,
        sk_bmod_sh=skc.B_shoup_q,
    )

    def padded(x):
        return jnp.asarray(_pad_rows(np.asarray(x), kb_pad))

    bc = _BskConsts(
        p=padded(smq.conv.p_dst),
        smq_phat=padded(smq.conv.phat_mod_dst),
        smq_phat_sh=padded(smq.conv.phat_shoup_dst),
        smq_qmod=padded(smq.q_mod_dst),
        smq_qmod_sh=padded(smq.q_shoup_dst),
        smq_inv_mt=padded(smq.inv_mt_dst),
        smq_inv_mt_sh=padded(smq.inv_mt_shoup_dst),
        floor_phat=padded(fc.conv.phat_mod_dst),
        floor_phat_sh=padded(fc.conv.phat_shoup_dst),
        floor_inv_q=padded(fc.inv_q_dst),
        floor_inv_q_sh=padded(fc.inv_q_shoup_dst),
    )

    # level-sliced NTT tables: q tables keep the first kk rows; the Bsk
    # slice keeps m_sk LAST (slice_tables_last), then pads to kb_pad rows
    tb_q = _ntt.slice_tables(ctx.ntt_q, kk)
    tb_bsk = _ntt.NTTTables(*(
        jnp.asarray(_pad_rows(np.asarray(f), kb_pad))
        for f in _ntt.slice_tables_last(ctx.ntt_bsk, kb)))
    plan = dict(kb=kb, kb_pad=kb_pad, qc=qc, bc=bc, tb_q=tb_q,
                tb_bsk=tb_bsk)
    cache[(n_devices, level)] = plan
    return plan


# ---------------------------------------------------------------------------
# local building blocks (run inside shard_map on per-device rows)
# ---------------------------------------------------------------------------


def _accum_rows(y_full, phat_loc, phat_sh_loc, p_loc):
    """sum_i y_i * (P/p_i) mod c_j for this device's dst rows.

    y_full [k, c, n] (gathered digits), phat_loc [kl, k], p_loc [kl]."""
    p4 = p_loc[:, None, None, None]
    terms = mm.mul_mod_shoup(
        y_full[None], phat_loc[:, :, None, None],
        phat_sh_loc[:, :, None, None], p4)        # [kl, k, c, n]
    return mm.add_mod_tree(terms, p4, axis=1)[:, 0]


def _alpha_mtilde(y_full, phat_mod_mt, inv_q_mt):
    """The SmMRq m_tilde-lane correction, replicated (cheap [c, n] work)."""
    k = y_full.shape[0]
    acc = jnp.zeros_like(y_full[0])
    for i in range(k):
        acc = (acc + (y_full[i] & _MASK16) * phat_mod_mt[i]) & _MASK16
    return (acc * inv_q_mt) & _MASK16


def _tensor_product_local(x, y, tb_loc, t_mod):
    """[kl, 2, n] x [kl, 2, n] -> t * (x (x) y) [kl, 3, n] on local rows."""
    f = _ntt.ntt_forward(jnp.concatenate([x, y], axis=1), tb_loc)
    xf, yf = f[:, :2], f[:, 2:]
    p = tb_loc.p[:, None, None]
    mu = tb_loc.mu[:, None, None]
    c0 = mm.mul_mod_barrett(xf[:, :1], yf[:, :1], p, mu)
    c2 = mm.mul_mod_barrett(xf[:, 1:], yf[:, 1:], p, mu)
    c1 = mm.add_mod(mm.mul_mod_barrett(xf[:, :1], yf[:, 1:], p, mu),
                    mm.mul_mod_barrett(xf[:, 1:], yf[:, :1], p, mu), p)
    tens = _ntt.ntt_inverse(jnp.concatenate([c0, c1, c2], axis=1), tb_loc)
    return mm.mul_mod_barrett(tens, jnp.broadcast_to(t_mod, tens.shape), p, mu)


def _keyswitch_local(d_full, keys_loc, tb_loc):
    """INTT(sum_j NTT(D_j) . key_j) on this device's prime rows.

    d_full [k, n] gathered gadget digits; keys_loc [kl, kd, 2, n]."""
    p = tb_loc.p
    dr = mm.barrett_reduce_u32(
        d_full[None], p[:, None, None], tb_loc.mu[:, None, None])
    f = _ntt.ntt_forward(dr, tb_loc)               # [kl, kd, n]
    p4 = p[:, None, None, None]
    prod = mm.mul_mod_barrett(
        f[:, :, None, :], keys_loc, p4, tb_loc.mu[:, None, None, None])
    acc = mm.add_mod_tree(prod, p4, axis=1)[:, 0]  # [kl, 2, n]
    return _ntt.ntt_inverse(acc, tb_loc)


# ---------------------------------------------------------------------------
# the explicit multiply + relinearize
# ---------------------------------------------------------------------------


def multiply_relin_shardmap(ctx, a: Ciphertext, b: Ciphertext,
                            rlk: RelinKeys, mesh: Mesh,
                            axis: str = "rns",
                            keys_at_level: bool = False) -> Ciphertext:
    """BEHZ multiply + relinearize with every cross-prime exchange an
    explicit collective (module docstring).  Any level with
    (k - level) % P == 0 (level-0 keys are mod-switched down unless
    keys_at_level); bit-exact with scheme.bfv.multiply
    (tests/test_shard_scheme.py)."""
    if a.level != b.level:
        raise ValueError("operands must share a level")
    from ..scheme.bfv import _omega as _ks_omega
    if _ks_omega(ctx) > 1:
        raise ValueError(
            "the explicit shard_map multiply builds per-prime gadget "
            "digits; grouped-gadget keys (ks_omega > 1) are not supported "
            "here — use ks_omega=1 parameters for the distributed path")
    level = a.level
    from ..scheme import bfv as _bfv
    a = _bfv.to_coeff(ctx, a)
    b = _bfv.to_coeff(ctx, b)
    n_dev = mesh.shape[axis]
    plan = build_plan(ctx, n_dev, level)
    keys = (rlk.data if keys_at_level
            else _bfv._switch_keys_down(ctx, rlk.data, level, False))
    keys_t = jnp.transpose(keys, (1, 0, 2, 3))       # [k_prime, kd, 2, n]

    fn = _build_shardmap_fn(ctx, mesh, axis, plan, level)
    out = fn(a.data, b.data, keys_t, plan["qc"], plan["bc"],
             plan["tb_q"], plan["tb_bsk"])
    v3 = _noise.bfv_multiply(ctx.params, _bfv._v_of(ctx, a),
                             _bfv._v_of(ctx, b))
    bud = _bfv._b_of(ctx, level, _noise.add(
        _noise.bfv_variance(ctx.params, level, _bfv._b_of(ctx, level, v3)),
        _noise.keyswitch_add(ctx.params, level)))
    return Ciphertext(data=out, level=level, is_ntt_form=False,
                      noise_budget=bud)


def _build_shardmap_fn(ctx, mesh: Mesh, axis: str, plan, level: int = 0):
    """The jitted shard_map program (cached per (params, mesh, axis, level))."""
    cache = getattr(ctx, "_shard_fn_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(ctx, "_shard_fn_cache", cache)
    key = (id(mesh), axis, mesh.shape[axis], level)
    if key in cache:
        return cache[key]

    kb = plan["kb"]
    smq = ctx.smq_levels[level]
    skc = ctx.sk_levels[level]
    t_mod = ctx.dec_c.t
    # replicated small constants (closed over: they are bytes, not tensors)
    phat_mod_mt = smq.phat_mod_mt
    inv_q_mt = smq.inv_q_mt
    sk_aux_inv = skc.conv_q.inv_phat          # [l] aux digit scale
    sk_aux_inv_sh = skc.conv_q.inv_phat_shoup
    sk_msk_phat = skc.conv_sk.phat_mod_dst    # [1, l]
    sk_msk_phat_sh = skc.conv_sk.phat_shoup_dst
    m_sk = skc.m_sk
    inv_B_sk, inv_B_sk_sh = skc.inv_B_sk, skc.inv_B_sk_shoup
    p_aux = skc.conv_q.p_src                  # [l]

    def local_fn(a_loc, b_loc, keys_loc, qc, bc, tbq, tbb):
        tb_loc = tbq
        p_loc = tb_loc.p[:, None, None]
        pb_loc = bc.p[:, None, None]

        # ---- SmMRq lift of both operands: digits -> all_gather -> local
        # Bsk rows + replicated m_tilde correction ----
        ab = jnp.concatenate([a_loc, b_loc], axis=1)            # [kl, 4, n]
        y_loc = mm.mul_mod_shoup(
            ab, qc.mt_inv_phat[:, None, None],
            qc.mt_inv_phat_sh[:, None, None], p_loc)
        y_full = lax.all_gather(y_loc, axis, axis=0, tiled=True)  # [k, 4, n]
        conv = _accum_rows(y_full, bc.smq_phat, bc.smq_phat_sh, bc.p)
        alpha = _alpha_mtilde(y_full, phat_mod_mt, inv_q_mt)[None]
        alpha_mod = jnp.where(alpha < _U(1 << 15), alpha,
                              pb_loc - (_U(1 << 16) - alpha))
        aq = mm.mul_mod_shoup(alpha_mod, bc.smq_qmod[:, None, None],
                              bc.smq_qmod_sh[:, None, None], pb_loc)
        lift = mm.mul_mod_shoup(
            mm.sub_mod(conv, aq, pb_loc), bc.smq_inv_mt[:, None, None],
            bc.smq_inv_mt_sh[:, None, None], pb_loc)            # [kbl, 4, n]

        # ---- tensor products in both bases (device-local NTTs) ----
        tx_q = _tensor_product_local(a_loc, b_loc, tb_loc, t_mod)
        tx_bsk = _tensor_product_local(lift[:, :2], lift[:, 2:], tbb,
                                       t_mod)                   # [kbl, 3, n]

        # ---- FastFloor: conv digits -> all_gather -> local Bsk rows ----
        y2_loc = mm.mul_mod_shoup(
            tx_q, qc.floor_inv_phat[:, None, None],
            qc.floor_inv_phat_sh[:, None, None], p_loc)
        y2_full = lax.all_gather(y2_loc, axis, axis=0, tiled=True)
        conv2 = _accum_rows(y2_full, bc.floor_phat, bc.floor_phat_sh, bc.p)
        floored = mm.mul_mod_shoup(
            mm.sub_mod(tx_bsk, conv2, pb_loc),
            bc.floor_inv_q[:, None, None], bc.floor_inv_q_sh[:, None, None],
            pb_loc)                                             # [kbl, 3, n]

        # ---- Shenoy-Kumaresan exact Bsk -> q: gather the (padded) Bsk
        # rows, convert to this device's q rows ----
        fl_full = lax.all_gather(floored, axis, axis=0, tiled=True)
        x_aux = fl_full[:kb - 1]                                # [l, 3, n]
        x_msk = fl_full[kb - 1]                                 # [3, n]
        y3 = mm.mul_mod_shoup(
            x_aux, sk_aux_inv[:, None, None], sk_aux_inv_sh[:, None, None],
            p_aux[:, None, None])
        conv_q = _accum_rows(y3, qc.sk_phat, qc.sk_phat_sh, tb_loc.p)
        # m_sk lane + centered alpha (replicated [3, n] work)
        terms_sk = mm.mul_mod_shoup(
            y3, sk_msk_phat[0][:, None, None],
            sk_msk_phat_sh[0][:, None, None], m_sk)
        conv_sk = mm.add_mod_tree(terms_sk, m_sk, axis=0)[0]
        alpha_sk = mm.mul_mod_shoup(
            mm.sub_mod(conv_sk, x_msk, m_sk), inv_B_sk, inv_B_sk_sh, m_sk)
        half = m_sk >> 1
        a_b = alpha_sk[None]
        alpha_q = jnp.where(a_b <= half, a_b, p_loc - (m_sk - a_b))
        aB = mm.mul_mod_shoup(alpha_q, qc.sk_bmod[:, None, None],
                              qc.sk_bmod_sh[:, None, None], p_loc)
        out3 = mm.sub_mod(conv_q, aB, p_loc)                    # [kl, 3, n]

        # ---- relinearize: gadget digits -> all_gather -> local fused
        # key-switch inner product on this device's prime rows ----
        d_loc = mm.mul_mod_shoup(
            out3[:, 2], qc.inv_qhat[:, None], qc.inv_qhat_sh[:, None],
            tb_loc.p[:, None])                                  # [kl, n]
        d_full = lax.all_gather(d_loc, axis, axis=0, tiled=True)  # [k, n]
        delta = _keyswitch_local(d_full, keys_loc, tb_loc)
        return mm.add_mod(out3[:, :2], delta, p_loc)

    spec_row = P(axis)  # shard the leading (prime) axis of every leaf
    in_specs = (
        spec_row, spec_row, spec_row,
        jax.tree_util.tree_map(lambda _: spec_row, plan["qc"]),
        jax.tree_util.tree_map(lambda _: spec_row, plan["bc"]),
        jax.tree_util.tree_map(lambda _: spec_row, plan["tb_q"]),
        jax.tree_util.tree_map(lambda _: spec_row, plan["tb_bsk"]),
    )
    fn = jax.jit(shard_map(local_fn, mesh=mesh, in_specs=in_specs,
                           out_specs=spec_row, check_vma=False))
    cache[key] = fn
    return fn


# ---------------------------------------------------------------------------
# psum-strategy key switch (collective-cost comparison; see module docstring)
# ---------------------------------------------------------------------------


def psum_mod(x, p, p_sh16, axis: str):
    """Exact modular all-reduce of per-device partials in [0, p), p < 2^30.

    Integer psum would overflow u32 at P >= 4 terms, so the value is split
    into 16-bit halves (each sum < P * 2^16 << 2^30, already reduced), then
    recombined as hi * 2^16 + lo mod p via one Shoup multiply.  p_sh16 is the
    Shoup companion of 2^16 mod p.  Two all-reduces of the tensor."""
    hi = lax.psum(x >> 16, axis)
    lo = lax.psum(x & _MASK16, axis)
    return mm.add_mod(mm.mul_mod_shoup(hi, _U(1 << 16), p_sh16, p), lo, p)


def keyswitch_delta_psum(ctx, poly: jax.Array, ks_keys: jax.Array,
                         mesh: Mesh, axis: str = "rns") -> jax.Array:
    """Key-switch correction with the inner product reduced by ``psum``:
    device j holds gadget digit rows j (keys digit-major sharded), computes
    NTT_i(D_j) * key_{j,i} partials for ALL primes i, and the digit-axis sum
    becomes an exact modular all-reduce (psum_mod).  Requires the full
    twiddle tables on every device — 2x the collective bytes and k x the
    table memory of the gather strategy in multiply_relin_shardmap; kept as
    the counterpoint for comparing collective costs.

    poly [k, n] coeff domain; ks_keys [kd, k, 2, n] digit-major.
    Returns [k, 2, n] coeff-domain delta, rows sharded; bit-exact with the
    composed single-device inner product."""
    k = ctx.k
    n_dev = mesh.shape[axis]
    if k % n_dev:
        raise ValueError(f"k % P != 0 (k={k}, P={n_dev})")
    tb = ctx.ntt_q
    sh16 = jnp.asarray(np.array(
        [mm.shoup_precompute(1 << 16, int(p)) for p in ctx.params.q_primes],
        dtype=_U))
    inv_qhat, inv_qhat_sh = ctx.inv_qhat_levels[0]

    # digit scaling is elementwise per digit row — it runs sharded as-is,
    # before the shard_map
    d_all = mm.mul_mod_shoup(poly, inv_qhat[:, None], inv_qhat_sh[:, None],
                             tb.p[:k, None])

    def local_fn(d_loc, keys_loc, tb_full):
        p_all = tb_full.p[:, None, None]
        mu_all = tb_full.mu[:, None, None]
        dr = mm.barrett_reduce_u32(d_loc[None], p_all, mu_all)
        f = _ntt.ntt_forward(dr, tb_full)              # [k, kdl, n]
        p4 = tb_full.p[:, None, None, None]
        prod = mm.mul_mod_barrett(
            f[:, :, None, :], jnp.transpose(keys_loc, (1, 0, 2, 3)), p4,
            tb_full.mu[:, None, None, None])
        partial = mm.add_mod_tree(prod, p4, axis=1)[:, 0]   # [k, 2, n]
        acc = psum_mod(partial, p_all, sh16[:, None, None], axis)
        idx = lax.axis_index(axis)
        kl = k // n_dev
        rows = lax.dynamic_slice_in_dim(acc, idx * kl, kl, axis=0)
        tb_loc = _ntt.NTTTables(*(
            lax.dynamic_slice_in_dim(f_, idx * kl, kl, axis=0)
            for f_ in tb_full))
        return _ntt.ntt_inverse(rows, tb_loc)

    fn = jax.jit(shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis), P(axis),
                  jax.tree_util.tree_map(lambda _: P(), tb)),
        out_specs=P(axis), check_vma=False))
    return fn(d_all, ks_keys, tb)
