"""RNS / CRT device layer — base conversions and exact rounded scaling.

Replaces the reference's RNS context (SURVEY.md §2.6: ``include/rns.cuh``,
``src/rns.cu`` — CRT reconstruction and fast base conversion are stubs or
declared-only there, e.g. ``from_rns_crt_kernel`` ``src/rns.cu:117-141``,
``fast_base_conversion_kernel`` ``include/rns.cuh:116-125``,
``rns_mod_switch_kernel`` ``include/rns.cuh:128-136``).

Everything here is all-integer uint32 arithmetic (BEHZ-style) so the exact
rounded division required by BFV decryption and multiplication needs no
float64.  Residue tensors are ``[k, batch, n]`` uint32, prime-major.

Each primitive is bit-exact with its oracle counterpart in
``fhe_jax.oracle`` (fast_base_conv / sm_mrq / fast_floor / fast_bconv_sk /
decrypt_scale_gamma / mod_switch_drop_last) — tests/test_rns.py.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from . import modmath as mm

_U = np.uint32
_MASK16 = np.uint32(0xFFFF)


def _shoup_arr(vals, mods):
    """Elementwise host Shoup companions."""
    return np.array(
        [mm.shoup_precompute(int(v), int(p)) for v, p in zip(vals, mods)],
        dtype=_U,
    )


# ---------------------------------------------------------------------------
# Fast base conversion  (src base P -> dst base C, adds alpha*P, alpha < k)
# ---------------------------------------------------------------------------


class BaseConvConsts(NamedTuple):
    p_src: jax.Array           # [k]
    inv_phat: jax.Array        # [k]   (P/p_i)^-1 mod p_i
    inv_phat_shoup: jax.Array  # [k]
    p_dst: jax.Array           # [l]
    phat_mod_dst: jax.Array    # [l, k]   (P/p_i) mod c_j
    phat_shoup_dst: jax.Array  # [l, k]


@functools.lru_cache(maxsize=None)
def _base_conv_host(src: tuple[int, ...], dst: tuple[int, ...]):
    P = math.prod(src)
    k, l = len(src), len(dst)
    inv_phat = [pow(P // p, -1, p) for p in src]
    phat_mod = np.zeros((l, k), dtype=_U)
    phat_sh = np.zeros((l, k), dtype=_U)
    for j, c in enumerate(dst):
        for i, p in enumerate(src):
            v = (P // p) % c
            phat_mod[j, i] = v
            phat_sh[j, i] = mm.shoup_precompute(v, c)
    return dict(
        p_src=np.array(src, dtype=_U),
        inv_phat=np.array(inv_phat, dtype=_U),
        inv_phat_shoup=_shoup_arr(inv_phat, src),
        p_dst=np.array(dst, dtype=_U),
        phat_mod_dst=phat_mod,
        phat_shoup_dst=phat_sh,
    )


def make_base_conv(src_primes, dst_primes) -> BaseConvConsts:
    host = _base_conv_host(tuple(int(p) for p in src_primes),
                           tuple(int(p) for p in dst_primes))
    return BaseConvConsts(**{f: jnp.asarray(v) for f, v in host.items()})


def _conv_digits(x: jax.Array, cc: BaseConvConsts) -> jax.Array:
    """y_i = [x_i * (P/p_i)^-1]_{p_i} — the shared digit step."""
    p = cc.p_src[:, None, None]
    return mm.mul_mod_shoup(
        x, cc.inv_phat[:, None, None], cc.inv_phat_shoup[:, None, None], p
    )


def fast_base_conv(x: jax.Array, cc: BaseConvConsts) -> jax.Array:
    """[k, B, n] residues in src base -> [l, B, n] residues of x + alpha*P.

    Reference: declared-only ``fast_base_conversion_kernel``
    (``include/rns.cuh:116-125``)."""
    y = _conv_digits(x, cc)
    return _accumulate(y, cc)


def _accumulate(y: jax.Array, cc: BaseConvConsts) -> jax.Array:
    """sum_i y_i * (P/p_i) mod c_j for every dst prime j (exact mod adds).

    One batched Shoup multiply over the source axis + a balanced mod-add
    tree, instead of a serial k-term fold (same op count, log-depth
    critical path — the BEHZ conversions are a large share of the multiply
    after the transforms were fused)."""
    p4 = cc.p_dst[:, None, None, None]
    terms = mm.mul_mod_shoup(
        y[None, :, :, :],                         # [1, k, B, n]
        cc.phat_mod_dst[:, :, None, None],        # [l, k, 1, 1]
        cc.phat_shoup_dst[:, :, None, None],
        p4,
    )                                             # [l, k, B, n]
    return mm.add_mod_tree(terms, p4, axis=1)[:, 0]


def _accumulate_mod_2e16(y: jax.Array, phat_mod_mt: jax.Array) -> jax.Array:
    """sum_i y_i * (P/p_i) mod 2^16 (m_tilde lane; masks instead of Barrett)."""
    k = y.shape[0]
    acc = jnp.zeros_like(y[0])
    for i in range(k):
        acc = (acc + (y[i] & _MASK16) * phat_mod_mt[i]) & _MASK16
    return acc


# ---------------------------------------------------------------------------
# SmMRq: exact (centered) lift q -> Bsk via the m_tilde correction (BEHZ)
# ---------------------------------------------------------------------------


class SmMRqConsts(NamedTuple):
    conv: BaseConvConsts        # q -> Bsk, with digits premultiplied by m_tilde
    mt_times_inv_phat: jax.Array        # [k]  [m_tilde * (q/q_i)^-1]_{q_i}
    mt_times_inv_phat_shoup: jax.Array  # [k]
    phat_mod_mt: jax.Array      # [k]  (q/q_i) mod 2^16
    inv_q_mt: jax.Array         # []   q^-1 mod 2^16
    q_mod_dst: jax.Array        # [l]  q mod c
    q_shoup_dst: jax.Array      # [l]
    inv_mt_dst: jax.Array       # [l]  m_tilde^-1 mod c
    inv_mt_shoup_dst: jax.Array # [l]


@functools.lru_cache(maxsize=None)
def _sm_mrq_host(src: tuple[int, ...], dst: tuple[int, ...], m_tilde: int):
    assert m_tilde == 1 << 16
    Q = math.prod(src)
    mt_inv_phat = [pow(Q // p, -1, p) * m_tilde % p for p in src]
    return dict(
        mt_times_inv_phat=np.array(mt_inv_phat, dtype=_U),
        mt_times_inv_phat_shoup=_shoup_arr(mt_inv_phat, src),
        phat_mod_mt=np.array([(Q // p) % m_tilde for p in src], dtype=_U),
        inv_q_mt=np.uint32(pow(Q, -1, m_tilde)),
        q_mod_dst=np.array([Q % c for c in dst], dtype=_U),
        q_shoup_dst=_shoup_arr([Q % c for c in dst], dst),
        inv_mt_dst=np.array([pow(m_tilde, -1, c) for c in dst], dtype=_U),
        inv_mt_shoup_dst=_shoup_arr([pow(m_tilde, -1, c) for c in dst], dst),
    )


def make_sm_mrq(src_primes, dst_primes, m_tilde: int = 1 << 16) -> SmMRqConsts:
    src = tuple(int(p) for p in src_primes)
    dst = tuple(int(p) for p in dst_primes)
    host = _sm_mrq_host(src, dst, m_tilde)
    return SmMRqConsts(
        conv=make_base_conv(src, dst),
        **{f: jnp.asarray(v) for f, v in host.items()},
    )


def sm_mrq(x: jax.Array, sc: SmMRqConsts) -> jax.Array:
    """Centered lift of x (residues in q, [k,B,n]) into the dst base [l,B,n].

    Output represents exactly x or x - q (centered), bit-exact with
    oracle.sm_mrq."""
    cc = sc.conv
    p_src = cc.p_src[:, None, None]
    # digits of m_tilde*x in one shot: y_i = [x_i * m_tilde * (q/q_i)^-1]_{q_i}
    y = mm.mul_mod_shoup(
        x,
        sc.mt_times_inv_phat[:, None, None],
        sc.mt_times_inv_phat_shoup[:, None, None],
        p_src,
    )
    conv = _accumulate(y, cc)                       # [l, B, n]
    conv_mt = _accumulate_mod_2e16(y, sc.phat_mod_mt)  # [B, n]
    alpha = (conv_mt * sc.inv_q_mt) & _MASK16       # [B, n] in [0, 2^16)
    # centered alpha mod c: alpha < 2^15 -> alpha ; else c - (2^16 - alpha)
    p_dst = cc.p_dst[:, None, None]
    alpha_b = alpha[None, :, :]
    alpha_mod = jnp.where(
        alpha_b < np.uint32(1 << 15),
        alpha_b,
        p_dst - (np.uint32(1 << 16) - alpha_b),
    )
    aq = mm.mul_mod_shoup(
        alpha_mod, sc.q_mod_dst[:, None, None], sc.q_shoup_dst[:, None, None], p_dst
    )
    centered = mm.sub_mod(conv, aq, p_dst)
    return mm.mul_mod_shoup(
        centered, sc.inv_mt_dst[:, None, None], sc.inv_mt_shoup_dst[:, None, None], p_dst
    )


# ---------------------------------------------------------------------------
# FastFloor: floor(t*x/q) - alpha in the Bsk base
# ---------------------------------------------------------------------------


class FastFloorConsts(NamedTuple):
    conv: BaseConvConsts        # q -> Bsk
    inv_q_dst: jax.Array        # [l]  q^-1 mod c
    inv_q_shoup_dst: jax.Array  # [l]


def make_fast_floor(src_primes, dst_primes) -> FastFloorConsts:
    src = tuple(int(p) for p in src_primes)
    dst = tuple(int(p) for p in dst_primes)
    Q = math.prod(src)
    inv_q = [pow(Q, -1, c) for c in dst]
    return FastFloorConsts(
        conv=make_base_conv(src, dst),
        inv_q_dst=jnp.asarray(np.array(inv_q, dtype=_U)),
        inv_q_shoup_dst=jnp.asarray(_shoup_arr(inv_q, dst)),
    )


def fast_floor(tx_q: jax.Array, tx_dst: jax.Array, fc: FastFloorConsts) -> jax.Array:
    """Given residues of t*x in q ([k,B,n]) and in the dst base ([l,B,n]),
    return floor(t*x/q) - alpha (alpha < k) in dst.  Bit-exact with
    oracle.fast_floor."""
    conv = fast_base_conv(tx_q, fc.conv)
    p_dst = fc.conv.p_dst[:, None, None]
    diff = mm.sub_mod(tx_dst, conv, p_dst)
    return mm.mul_mod_shoup(
        diff, fc.inv_q_dst[:, None, None], fc.inv_q_shoup_dst[:, None, None], p_dst
    )


# ---------------------------------------------------------------------------
# FastBConvSK: exact signed conversion Bsk -> q (Shenoy-Kumaresan)
# ---------------------------------------------------------------------------


class SKConsts(NamedTuple):
    conv_q: BaseConvConsts      # B -> q
    conv_sk: BaseConvConsts     # B -> {m_sk}
    m_sk: jax.Array             # []
    inv_B_sk: jax.Array         # []   B^-1 mod m_sk
    inv_B_sk_shoup: jax.Array
    B_mod_q: jax.Array          # [k]
    B_shoup_q: jax.Array


def make_sk(aux_primes, m_sk: int, dst_primes) -> SKConsts:
    aux = tuple(int(p) for p in aux_primes)
    dst = tuple(int(p) for p in dst_primes)
    B = math.prod(aux)
    inv_B_sk = pow(B, -1, m_sk)
    return SKConsts(
        conv_q=make_base_conv(aux, dst),
        conv_sk=make_base_conv(aux, (m_sk,)),
        m_sk=jnp.uint32(m_sk),
        inv_B_sk=jnp.uint32(inv_B_sk),
        inv_B_sk_shoup=jnp.uint32(mm.shoup_precompute(inv_B_sk, m_sk)),
        B_mod_q=jnp.asarray(np.array([B % c for c in dst], dtype=_U)),
        B_shoup_q=jnp.asarray(_shoup_arr([B % c for c in dst], dst)),
    )


def fast_bconv_sk(x_bsk: jax.Array, sk: SKConsts) -> jax.Array:
    """x_bsk: [l+1, B, n] (aux rows then the m_sk row) -> exact [k, B, n] in q.

    Valid for |x| < B*m_sk/2-ish (signed).  Bit-exact with oracle.fast_bconv_sk."""
    x_aux = x_bsk[:-1]
    x_msk = x_bsk[-1]                                # [B, n]
    conv_q = fast_base_conv(x_aux, sk.conv_q)        # [k, B, n]
    conv_sk = fast_base_conv(x_aux, sk.conv_sk)[0]   # [B, n]
    msk = sk.m_sk
    alpha = mm.mul_mod_shoup(
        mm.sub_mod(conv_sk, x_msk, msk), sk.inv_B_sk, sk.inv_B_sk_shoup, msk
    )                                                # [B, n] in [0, m_sk)
    p_dst = sk.conv_q.p_dst[:, None, None]
    half = msk >> 1
    alpha_b = alpha[None, :, :]
    # centered alpha mod c: alpha (pos, alpha <= m_sk/2 < c) or
    # c - (m_sk - alpha) (neg, with 0 < m_sk - alpha <= m_sk/2 < c).
    alpha_mod = jnp.where(alpha_b <= half, alpha_b, p_dst - (msk - alpha_b))
    aB = mm.mul_mod_shoup(
        alpha_mod, sk.B_mod_q[:, None, None], sk.B_shoup_q[:, None, None], p_dst
    )
    return mm.sub_mod(conv_q, aB, p_dst)


# ---------------------------------------------------------------------------
# Exact RNS decryption scaling (gamma trick) — m = round(t*x/q) mod t
# ---------------------------------------------------------------------------


class DecryptConsts(NamedTuple):
    p_src: jax.Array            # [k]
    gt_inv_phat: jax.Array      # [k]  [gamma*t*(q/q_i)^-1]_{q_i}
    gt_inv_phat_shoup: jax.Array
    t: jax.Array                # []
    gamma: jax.Array            # []
    phat_mod_t: jax.Array       # [k]
    phat_shoup_t: jax.Array     # [k]  Shoup companions mod t (generic-t path)
    phat_mod_g: jax.Array       # [k]
    neg_inv_q_t: jax.Array      # []  [-q^-1]_t
    neg_inv_q_t_shoup: jax.Array
    neg_inv_q_g: jax.Array      # []  [-q^-1]_gamma
    inv_gamma_t: jax.Array      # []  gamma^-1 mod t
    inv_gamma_t_shoup: jax.Array
    gamma_mod_t: jax.Array      # []  [gamma]_t
    one_shoup_t: jax.Array      # []  floor(2^32/t): generic u32 mod-t reduce
    gamma_mu: jax.Array         # []  Barrett mu for gamma


@functools.lru_cache(maxsize=None)
def _decrypt_host(src: tuple[int, ...], t: int, gamma: int):
    Q = math.prod(src)
    gt_inv = [gamma * t % p * pow(Q // p, -1, p) % p for p in src]
    phat_t = [(Q // p) % t for p in src]
    neg_inv_q_t = (-pow(Q, -1, t)) % t
    inv_gamma_t = pow(gamma, -1, t)
    return dict(
        p_src=np.array(src, dtype=_U),
        gt_inv_phat=np.array(gt_inv, dtype=_U),
        gt_inv_phat_shoup=_shoup_arr(gt_inv, src),
        t=np.uint32(t),
        gamma=np.uint32(gamma),
        phat_mod_t=np.array(phat_t, dtype=_U),
        phat_shoup_t=_shoup_arr(phat_t, [t] * len(src)),
        phat_mod_g=np.array([(Q // p) % gamma for p in src], dtype=_U),
        neg_inv_q_t=np.uint32(neg_inv_q_t),
        neg_inv_q_t_shoup=np.uint32(mm.shoup_precompute(neg_inv_q_t, t)),
        neg_inv_q_g=np.uint32((-pow(Q, -1, gamma)) % gamma),
        inv_gamma_t=np.uint32(inv_gamma_t),
        inv_gamma_t_shoup=np.uint32(mm.shoup_precompute(inv_gamma_t, t)),
        gamma_mod_t=np.uint32(gamma % t),
        one_shoup_t=np.uint32(mm.shoup_precompute(1, t)),
        gamma_mu=np.uint32(mm.barrett_precompute(gamma)),
    )


def make_decrypt(src_primes, t: int, gamma: int) -> DecryptConsts:
    if not (65537 <= t < (1 << 29)):
        raise ValueError(
            f"decrypt_scale needs 65537 <= t < 2^29, got {t} (see params.py)")
    host = _decrypt_host(tuple(int(p) for p in src_primes), t, gamma)
    return DecryptConsts(**{f: jnp.asarray(v) for f, v in host.items()})


def decrypt_scale(x: jax.Array, dc: DecryptConsts,
                  fermat: bool = False) -> jax.Array:
    """x: [k, B, n] residues of the phase c0 + c1*s (+...), coefficient domain.
    Returns [B, n] uint32 plaintext coefficients mod t.  Bit-exact with
    oracle.decrypt_scale_gamma for any valid t.

    fermat=True selects the t = 65537 fast path (2^16 ≡ -1 folds instead of
    Shoup multiplies in the t lane); it must only be set when the constants
    were built with t = 65537.  The flag is static: callers pass
    ``params.t == 65537`` so each trace picks one lane implementation."""
    p = dc.p_src[:, None, None]
    # digits of [gamma*t*x]_q: z_i = [x_i * gamma*t*(q/q_i)^-1]_{q_i}
    z = mm.mul_mod_shoup(x, dc.gt_inv_phat[:, None, None],
                         dc.gt_inv_phat_shoup[:, None, None], p)
    # accumulate into the t and gamma lanes: one batched multiply over the
    # prime axis + balanced mod-add trees (no serial fold)
    t = dc.t
    g = dc.gamma
    if fermat:
        terms_t = mm.mul_mod_fermat16(
            mm.reduce_mod_fermat16(z), dc.phat_mod_t[:, None, None])
        scale_t = lambda a, w, ws: mm.mul_mod_fermat16(a, w)
        red_t = mm.reduce_mod_fermat16
    else:
        terms_t = mm.mul_mod_shoup(
            z, dc.phat_mod_t[:, None, None], dc.phat_shoup_t[:, None, None],
            t)
        scale_t = lambda a, w, ws: mm.mul_mod_shoup(a, w, ws, t)
        red_t = lambda a: mm.reduce_mod_shoup(a, t, dc.one_shoup_t)
    acc_t = mm.add_mod_tree(terms_t, t, axis=0)[0]
    terms_g = mm.mul_mod_barrett(
        mm.barrett_reduce_u32(z, g, dc.gamma_mu),
        dc.phat_mod_g[:, None, None], g, dc.gamma_mu)
    acc_g = mm.add_mod_tree(terms_g, g, axis=0)[0]
    s_t = scale_t(acc_t, dc.neg_inv_q_t, dc.neg_inv_q_t_shoup)
    s_g = mm.mul_mod_barrett(acc_g, dc.neg_inv_q_g, g, dc.gamma_mu)
    # center s_g and correct: m = (s_t - e_hat) * gamma^-1 mod t
    e_pos = s_g <= (g >> 1)
    # e_hat mod t: s_g (pos branch) or s_g - gamma (neg branch)
    e_mod_t = jnp.where(
        e_pos,
        red_t(s_g),
        mm.sub_mod(red_t(s_g), dc.gamma_mod_t, t),
    )
    num = mm.sub_mod(s_t, e_mod_t, t)
    return scale_t(num, dc.inv_gamma_t, dc.inv_gamma_t_shoup)


# ---------------------------------------------------------------------------
# RNS modulus switching: drop the last prime with rounding
# ---------------------------------------------------------------------------


class ModSwitchConsts(NamedTuple):
    p_keep: jax.Array           # [k-1]
    q_last: jax.Array           # []
    inv_qlast: jax.Array        # [k-1]  q_last^-1 mod p_i
    inv_qlast_shoup: jax.Array


def make_mod_switch(primes_tuple) -> ModSwitchConsts:
    ps = tuple(int(p) for p in primes_tuple)
    keep, last = ps[:-1], ps[-1]
    inv = [pow(last, -1, p) for p in keep]
    return ModSwitchConsts(
        p_keep=jnp.asarray(np.array(keep, dtype=_U)),
        q_last=jnp.uint32(last),
        inv_qlast=jnp.asarray(np.array(inv, dtype=_U)),
        inv_qlast_shoup=jnp.asarray(_shoup_arr(inv, keep)),
    )


def mod_switch_drop_last(x: jax.Array, mc: ModSwitchConsts) -> jax.Array:
    """[k, B, n] -> [k-1, B, n]: round(x / q_last) in the remaining basis.
    Bit-exact with oracle.mod_switch_drop_last."""
    x_keep = x[:-1]
    x_last = x[-1]                                   # [B, n]
    q_last = mc.q_last
    half = q_last >> 1
    p = mc.p_keep[:, None, None]
    # delta centered: subtract x_last (small) or add q_last - x_last
    pos = (x_last <= half)[None, :, :]
    x_last_b = x_last[None, :, :]
    # reduce x_last mod p (x_last < q_last < 2p always for same-width primes)
    xl_mod = jnp.where(x_last_b >= p, x_last_b - p, x_last_b)
    shifted = jnp.where(
        pos,
        mm.sub_mod(x_keep, xl_mod, p),
        mm.add_mod(x_keep, jnp.where(q_last - x_last_b >= p,
                                     q_last - x_last_b - p,
                                     q_last - x_last_b), p),
    )
    return mm.mul_mod_shoup(
        shifted, mc.inv_qlast[:, None, None], mc.inv_qlast_shoup[:, None, None], p
    )


# ---------------------------------------------------------------------------
# BGV modulus switching: drop the last prime with the mod-t correction
# d = t * [[x * t^-1]]_{q_last} so that d = x (mod q_last) and d = 0 (mod t)
# ---------------------------------------------------------------------------


class BGVModSwitchConsts(NamedTuple):
    p_keep: jax.Array            # [k-1]
    q_last: jax.Array            # []
    inv_t_qlast: jax.Array       # []   t^-1 mod q_last
    inv_t_qlast_shoup: jax.Array
    t_mod_keep: jax.Array        # [k-1] t mod p_i (t < p_i so == t)
    t_shoup_keep: jax.Array      # [k-1]
    inv_qlast: jax.Array         # [k-1] q_last^-1 mod p_i
    inv_qlast_shoup: jax.Array


def make_bgv_mod_switch(primes_tuple, t: int) -> BGVModSwitchConsts:
    ps = tuple(int(p) for p in primes_tuple)
    keep, last = ps[:-1], ps[-1]
    inv_t = pow(t, -1, last)
    inv_l = [pow(last, -1, p) for p in keep]
    return BGVModSwitchConsts(
        p_keep=jnp.asarray(np.array(keep, dtype=_U)),
        q_last=jnp.uint32(last),
        inv_t_qlast=jnp.uint32(inv_t),
        inv_t_qlast_shoup=jnp.uint32(mm.shoup_precompute(inv_t, last)),
        t_mod_keep=jnp.asarray(np.array([t % p for p in keep], dtype=_U)),
        t_shoup_keep=jnp.asarray(_shoup_arr([t % p for p in keep], keep)),
        inv_qlast=jnp.asarray(np.array(inv_l, dtype=_U)),
        inv_qlast_shoup=jnp.asarray(_shoup_arr(inv_l, keep)),
    )


def bgv_mod_switch_drop_last(x: jax.Array, mc: BGVModSwitchConsts) -> jax.Array:
    """[k, B, n] -> [k-1, B, n]: (x - d)/q_last with the d above.  Bit-exact
    with oracle.BGVOracle.mod_switch_drop_last (per-component)."""
    x_keep = x[:-1]
    x_last = x[-1]                                       # [B, n]
    q_last = mc.q_last
    # v = [x * t^-1]_{q_last}, then centered: vc in (-q_last/2, q_last/2]
    v = mm.mul_mod_shoup(x_last, mc.inv_t_qlast, mc.inv_t_qlast_shoup, q_last)
    pos = (v <= (q_last >> 1))[None, :, :]
    p = mc.p_keep[:, None, None]
    v_b = v[None, :, :]
    v_mod = jnp.where(v_b >= p, v_b - p, v_b)            # v mod p_i (v < 2p)
    nv = q_last - v_b                                    # |centered| when neg
    nv_mod = jnp.where(nv >= p, nv - p, nv)
    # d mod p_i = +- t * |vc| mod p_i
    d_pos = mm.mul_mod_shoup(v_mod, mc.t_mod_keep[:, None, None],
                             mc.t_shoup_keep[:, None, None], p)
    d_neg = mm.neg_mod(
        mm.mul_mod_shoup(nv_mod, mc.t_mod_keep[:, None, None],
                         mc.t_shoup_keep[:, None, None], p), p)
    d = jnp.where(pos, d_pos, d_neg)
    shifted = mm.sub_mod(x_keep, d, p)
    return mm.mul_mod_shoup(
        shifted, mc.inv_qlast[:, None, None], mc.inv_qlast_shoup[:, None, None], p
    )


# ---------------------------------------------------------------------------
# Host-side big-int <-> RNS (the encode/decode boundary, like the reference's
# cudaMemcpy paths src/fhe.cu:123-130)
# ---------------------------------------------------------------------------


def to_rns_host(coeffs, primes_list) -> np.ndarray:
    """[n] Python ints -> [k, n] uint32."""
    return np.stack(
        [np.array([int(c) % p for c in coeffs], dtype=_U) for p in primes_list]
    )


def from_rns_host(res: np.ndarray, primes_list) -> list[int]:
    """[k, n] uint32 -> [n] Python ints in [0, Q) — exact CRT on host
    (native C++ fast path in native/fhecore when built)."""
    ps = [int(p) for p in primes_list]
    Q = math.prod(ps)
    mults = [Q // p * pow(Q // p, -1, p) % Q for p in ps]
    out = []
    for j in range(res.shape[1]):
        acc = 0
        for i in range(len(ps)):
            acc += int(res[i, j]) * mults[i]
        out.append(acc % Q)
    return out
