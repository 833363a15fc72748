"""Distributed negacyclic NTT over coefficient blocks (shard_map + ppermute).

Scales polynomial degree n beyond one device: the coefficient axis is block-
sharded over a ``coeff`` mesh axis of size P.  In the merged-psi CT stage
loop (ops/ntt.py), a stage with m groups pairs elements at stride
t = n/(2m):

  * stages m = 1 .. P/2  — the partner lives in another shard at the *same
    local offset*; each stage is one pairwise block exchange
    (``jax.lax.ppermute``) + a full-width local
    butterfly.  log2(P) exchange stages total, each moving one block.
  * stages m = P .. n/2  — entirely shard-local; identical math to the
    single-device engine with per-shard twiddle slices.

This realizes the reference's *documented* multi-GPU plan — "split
coefficients across 4 GPUs, exchange butterfly pairs over NVLink"
(reference ``docs/NTT_OPTIMIZATION.md:315-325``,
``docs/ARCHITECTURE.md:499-511``) — which had no code.  The inverse transform mirrors it (local GS stages first,
then the exchange stages, then the n^-1 scale).

Bit-exact with ops/ntt.py on the gathered result (tests/test_parallel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import modmath as mm
from ..ops.ntt import NTTTables


def _pair_perm(P_: int, offset: int) -> list[tuple[int, int]]:
    """Full pairwise exchange permutation: s <-> s +- offset within groups."""
    perm = []
    for s in range(P_):
        pos = s % (2 * offset)
        partner = s + offset if pos < offset else s - offset
        perm.append((s, partner))
    return perm


def _local_slice(table: jax.Array, start, size: int) -> jax.Array:
    """[k, n] table -> [k, size] slice at traced start."""
    return lax.dynamic_slice_in_dim(table, start, size, axis=1)


def _fwd_local_stages(a, tb: NTTTables, n: int, m0: int, s):
    """CT stages m = m0 .. n/2 on a local [k, B, L] block of shard s."""
    k, b, L = a.shape
    p4 = tb.p[:, None, None, None]
    m = m0
    while m < n:
        t = n // (2 * m)
        g = (m * L) // n  # groups fully inside this shard
        w = _local_slice(tb.psi_br, m + s * g, g)[:, None, :, None]
        ws = _local_slice(tb.psi_br_shoup, m + s * g, g)[:, None, :, None]
        x = a.reshape(k, b, g, 2, t)
        u = x[:, :, :, 0, :]
        v = mm.mul_mod_shoup(x[:, :, :, 1, :], w, ws, p4)
        a = jnp.stack((mm.add_mod(u, v, p4), mm.sub_mod(u, v, p4)),
                      axis=3).reshape(k, b, L)
        m *= 2
    return a


def _inv_local_stages(a, tb: NTTTables, n: int, m_stop: int, s):
    """GS stages m = n/2 down to m_stop on a local [k, B, L] block."""
    k, b, L = a.shape
    p4 = tb.p[:, None, None, None]
    m = n // 2
    while m >= m_stop:
        t = n // (2 * m)
        g = (m * L) // n
        w = _local_slice(tb.ipsi_br, m + s * g, g)[:, None, :, None]
        ws = _local_slice(tb.ipsi_br_shoup, m + s * g, g)[:, None, :, None]
        x = a.reshape(k, b, g, 2, t)
        u = x[:, :, :, 0, :]
        v = x[:, :, :, 1, :]
        a = jnp.stack(
            (mm.add_mod(u, v, p4),
             mm.mul_mod_shoup(mm.sub_mod(u, v, p4), w, ws, p4)),
            axis=3,
        ).reshape(k, b, L)
        m //= 2
    return a


def _check_shards(num_shards: int):
    if num_shards & (num_shards - 1):
        raise ValueError(
            f"coeff axis size must be a power of two (got {num_shards}): "
            "cross-shard butterfly pairing assumes power-of-two strides")


def dist_ntt_forward(a_local, tb: NTTTables, n: int, num_shards: int,
                     axis: str = "coeff"):
    """shard_map body: forward NTT on block-sharded [k, B, n/P] residues."""
    _check_shards(num_shards)
    s = lax.axis_index(axis)
    p3 = tb.p[:, None, None]
    m = 1
    # cross-shard exchange stages
    while m <= num_shards // 2:
        offset = num_shards // (2 * m)
        group = s * m // num_shards                 # traced group index
        w = _local_slice(tb.psi_br, m + group, 1)[:, :, None]        # [k,1,1]
        ws = _local_slice(tb.psi_br_shoup, m + group, 1)[:, :, None]
        other = lax.ppermute(a_local, axis, _pair_perm(num_shards, offset))
        first = (s % (2 * offset)) < offset
        w_mine = mm.mul_mod_shoup(a_local, w, ws, p3)
        w_other = mm.mul_mod_shoup(other, w, ws, p3)
        a_local = jnp.where(
            first,
            mm.add_mod(a_local, w_other, p3),   # U + w*V  (I hold U)
            mm.sub_mod(other, w_mine, p3),      # U - w*V  (I hold V)
        )
        m *= 2
    # local stages
    return _fwd_local_stages(a_local, tb, n, m, s)


def dist_ntt_inverse(a_local, tb: NTTTables, n: int, num_shards: int,
                     axis: str = "coeff"):
    """shard_map body: inverse NTT on block-sharded [k, B, n/P] residues."""
    _check_shards(num_shards)
    s = lax.axis_index(axis)
    p3 = tb.p[:, None, None]
    # local GS stages first (m = n/2 .. P)
    a_local = _inv_local_stages(a_local, tb, n, num_shards, s)
    # cross-shard stages m = P/2 .. 1
    m = num_shards // 2
    while m >= 1:
        offset = num_shards // (2 * m)
        group = s * m // num_shards
        w = _local_slice(tb.ipsi_br, m + group, 1)[:, :, None]
        ws = _local_slice(tb.ipsi_br_shoup, m + group, 1)[:, :, None]
        other = lax.ppermute(a_local, axis, _pair_perm(num_shards, offset))
        first = (s % (2 * offset)) < offset
        # first: U' = U + V ; second: V' = (U - V) * w  (I hold V, other=U)
        summed = mm.add_mod(a_local, other, p3)
        diffed = mm.mul_mod_shoup(mm.sub_mod(other, a_local, p3), w, ws, p3)
        a_local = jnp.where(first, summed, diffed)
        m //= 2
    return mm.mul_mod_shoup(
        a_local, tb.n_inv[:, None, None], tb.n_inv_shoup[:, None, None], p3)


def make_distributed_polymul(mesh: Mesh, tb: NTTTables, n: int,
                             axis: str = "coeff"):
    """Jitted distributed negacyclic polymul over a coefficient-sharded mesh.

    Returns f(a, b) for [k, B, n] inputs sharded P(None, None, axis)."""
    num_shards = mesh.shape[axis]
    _check_shards(num_shards)
    spec = P(None, None, axis)
    rep = P()  # fully replicated (valid for every table leaf rank)

    def local_fn(a, b, tables):
        fa = dist_ntt_forward(a, tables, n, num_shards, axis)
        fb = dist_ntt_forward(b, tables, n, num_shards, axis)
        prod = mm.mul_mod_barrett(
            fa, fb, tables.p[:, None, None], tables.mu[:, None, None])
        return dist_ntt_inverse(prod, tables, n, num_shards, axis)

    shmapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec, spec, rep),  # tables replicated via in_specs
        out_specs=spec,
    )
    return jax.jit(functools.partial(_apply3, shmapped, tb))


def _apply3(f, tb, a, b):
    return f(a, b, tb)


# ---------------------------------------------------------------------------
# scheme-level coefficient-sharded multiply + relinearize (SURVEY §7 stage 7)
# ---------------------------------------------------------------------------


def _tensor_dist(x, y, tb, n, num_shards, axis, t_mod):
    """t * (x ⊗ y) on coeff-sharded [k, 2, L] blocks -> [k, 3, L]."""
    f = dist_ntt_forward(jnp.concatenate([x, y], axis=1), tb, n,
                         num_shards, axis)
    xf, yf = f[:, :2], f[:, 2:]
    p = tb.p[:, None, None]
    mu = tb.mu[:, None, None]
    c0 = mm.mul_mod_barrett(xf[:, :1], yf[:, :1], p, mu)
    c2 = mm.mul_mod_barrett(xf[:, 1:], yf[:, 1:], p, mu)
    c1 = mm.add_mod(mm.mul_mod_barrett(xf[:, :1], yf[:, 1:], p, mu),
                    mm.mul_mod_barrett(xf[:, 1:], yf[:, :1], p, mu), p)
    tens = dist_ntt_inverse(jnp.concatenate([c0, c1, c2], axis=1), tb, n,
                            num_shards, axis)
    return mm.mul_mod_barrett(tens, jnp.broadcast_to(t_mod, tens.shape),
                              p, mu)


def multiply_relin_coeff_sharded(ctx, a, b, rlk, mesh: Mesh,
                                 axis: str = "coeff"):
    """Full BEHZ multiply + relinearize with the COEFFICIENT axis sharded —
    ring degrees beyond one device's memory (the reference's documented
    multi-GPU NTT plan, which had no code).

    Every BEHZ base conversion (SmMRq / FastFloor / Shenoy-Kumaresan) and
    the key-switch inner product are POINTWISE per coefficient, so they run
    shard-local with zero communication; the only cross-shard traffic is
    the log2(P) ppermute exchange stages inside each distributed NTT.
    Level-0 ciphertexts; bit-exact with the single-device jnp-engine
    bfv.multiply (tests/test_parallel.py)."""
    from ..ops import rns as _rns
    from ..scheme import bfv as _bfv
    from ..scheme import noise as _noise
    from ..scheme.types import Ciphertext

    if a.level or b.level:
        raise ValueError("coeff-sharded multiply covers level 0")
    a = _bfv.to_coeff(ctx, a)
    b = _bfv.to_coeff(ctx, b)
    n = ctx.n
    num_shards = mesh.shape[axis]
    _check_shards(num_shards)
    smq = ctx.smq_levels[0]
    fc = ctx.floor_levels[0]
    skc = ctx.sk_levels[0]
    inv_qhat, inv_qhat_sh = ctx.inv_qhat_levels[0]
    t_mod = ctx.dec_c.t
    tb_q = ctx.ntt_q
    from ..ops.ntt import slice_tables_last
    tb_bsk = slice_tables_last(ctx.ntt_bsk, ctx.bsk_counts[0])
    keys_t = jnp.transpose(rlk.data, (1, 0, 2, 3))    # [k_prime, kd, 2, n]

    def local_fn(a_loc, b_loc, keys_loc, tbq, tbb):
        # BEHZ conversions: pointwise per coefficient -> the single-chip
        # rns code runs unchanged on the local block
        lift_a = _rns.sm_mrq(a_loc, smq)
        lift_b = _rns.sm_mrq(b_loc, smq)
        tx_q = _tensor_dist(a_loc, b_loc, tbq, n, num_shards, axis, t_mod)
        tx_bsk = _tensor_dist(lift_a, lift_b, tbb, n, num_shards, axis,
                              t_mod)
        floored = _rns.fast_floor(tx_q, tx_bsk, fc)
        out3 = _rns.fast_bconv_sk(floored, skc)       # [k, 3, L]
        # key switch: digit scale + per-prime reduce are elementwise; the
        # two transforms are distributed; inner product is pointwise-local
        d = mm.mul_mod_shoup(out3[:, 2], inv_qhat[:, None],
                             inv_qhat_sh[:, None], tbq.p[:, None])
        d_all = mm.barrett_reduce_u32(
            d[None], tbq.p[:, None, None], tbq.mu[:, None, None])
        f = dist_ntt_forward(d_all, tbq, n, num_shards, axis)
        p4 = tbq.p[:, None, None, None]
        prod = mm.mul_mod_barrett(
            f[:, :, None, :], keys_loc, p4, tbq.mu[:, None, None, None])
        acc = mm.add_mod_tree(prod, p4, axis=1)[:, 0]  # [k, 2, L]
        delta = dist_ntt_inverse(acc, tbq, n, num_shards, axis)
        return mm.add_mod(out3[:, :2], delta, tbq.p[:, None, None])

    spec = P(None, None, axis)
    kspec = P(None, None, None, axis)
    rep = P()
    fn = jax.jit(jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(spec, spec, kspec, rep, rep),
        out_specs=spec))
    out = fn(a.data, b.data, keys_t, tb_q, tb_bsk)
    v3 = _noise.bfv_multiply(ctx.params, _bfv._v_of(ctx, a),
                             _bfv._v_of(ctx, b))
    bud = _bfv._b_of(ctx, 0, _noise.add(
        v3, _noise.keyswitch_add(ctx.params, 0)))
    return Ciphertext(data=out, level=0, is_ntt_form=False,
                      noise_budget=bud)
