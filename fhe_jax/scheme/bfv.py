"""BFV scheme operations — the full homomorphic op set, jittable.

Functional counterpart of the reference ``FHEContext`` methods
(``include/fhe.cuh:78-148``, bodies ``src/fhe.cu`` — several are stubs or
declared-only there; SURVEY.md §2.9 row lists them all).  Implemented here:

  keygen, relinkey_gen, galoiskey_gen          (src/fhe.cu:54-111 + :86 decl)
  encrypt, decrypt                              (src/fhe.cu:138-185)
  add, add_plain, sub, sub_plain                (src/fhe.cu:187-197 + :98-100 decl)
  multiply (BEHZ RNS), multiply_plain           (src/fhe.cu:199-224 + :104 decl)
  relinearize (real key switch, not the reference's truncation stub :226-235)
  mod_switch_to_next / mod_switch_to_level      (decl :109-110)
  apply_galois, rotate_rows, rotate_columns     (decl :113-116)
  key_switch                                    (decl :134-135)
  modulus_raise + bootstrap (re-encryption refresh; the reference's declared
  sk-taking signature, :119, :138-140)
  estimate_noise_budget (host-exact)            (decl :122)

Conventions:
  * ciphertexts canonical in coefficient domain ([0, q) representatives);
    NTT forms used internally and available via to_ntt/to_coeff,
  * every function is pure; randomness comes in as a jax PRNG key,
  * noise_budget is a TRACED scalar pytree leaf following the variance
    model in scheme/noise.py (the reference's analog is ad-hoc float
    bookkeeping, src/fhe.cu:168,195-196,222); estimate_noise_budget /
    exact_noise_budget give measured values.

All semantics are pinned by tests against fhe_jax.oracle (tests/test_bfv.py),
including bit-exactness of the multiply pipeline vs oracle.behz_multiply_no_relin.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import modmath as mm
from ..ops import ntt as _ntt
from ..ops import poly as _poly
from ..ops import rns as _rns
from ..ops import sampling
from . import context as _context
from .context import SchemeContext
from . import noise as _noise
from .types import Ciphertext, GaloisKeys, Plaintext, PublicKey, RelinKeys, SecretKey


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _tb(ctx: SchemeContext, level: int = 0) -> _ntt.NTTTables:
    k = ctx.k - level
    return _ntt.slice_tables(ctx.ntt_q, k)


def _fwd_q(ctx: SchemeContext, x, level: int = 0):
    """Forward NTT in the level-L q basis (row slice of the level-0 tables)."""
    return _ntt.ntt_forward(x, _tb(ctx, level))


def _inv_q(ctx: SchemeContext, x, level: int = 0):
    return _ntt.ntt_inverse(x, _tb(ctx, level))


def _tb_bsk(ctx: SchemeContext, level: int = 0) -> _ntt.NTTTables:
    """Level's Bsk-base tables: the BEHZ aux base shrinks with q (suffix
    slice so m_sk, the Shenoy-Kumaresan anchor, stays last — bsk_counts in
    scheme/context.py)."""
    return _ntt.slice_tables_last(ctx.ntt_bsk, ctx.bsk_counts[level])


def _fwd_bsk(ctx: SchemeContext, x, level: int = 0):
    return _ntt.ntt_forward(x, _tb_bsk(ctx, level))


def _inv_bsk(ctx: SchemeContext, x, level: int = 0):
    return _ntt.ntt_inverse(x, _tb_bsk(ctx, level))


def _p3(tb):  # [k,1,1] prime broadcast for [k,B,n] tensors
    return tb.p[:, None, None]


def _fresh_noise_budget(ctx: SchemeContext):
    """Fresh budget from the variance model (scheme/noise.py)."""
    return max(0.0, float(_noise.bfv_budget(
        ctx.params, 0, _noise.fresh_variance(ctx.params))))


def _v_of(ctx: SchemeContext, ct: Ciphertext):
    """Recover the tracked log2-noise-variance from the carried budget bits
    (possibly a traced scalar — see scheme/noise.py)."""
    return _noise.bfv_variance(ctx.params, ct.level, ct.noise_budget)


def _b_of(ctx: SchemeContext, level: int, log2_var):
    return jnp.maximum(0.0, _noise.bfv_budget(ctx.params, level, log2_var))


def _omega(ctx: SchemeContext) -> int:
    """Key-switch gadget rank (primes per gadget digit); 1 = classic."""
    return getattr(ctx.params.security, "ks_omega", 1)


def _grouped_digit_residues(ctx: SchemeContext, y: jax.Array,
                            level: int) -> jax.Array:
    """Grouped-gadget digits from standard per-prime digits (ks_omega > 1).

    y: [kq, *B, n] with y[j] = [c * (q/q_j)^-1]_{q_j} (u32 < q_j).
    Returns [kq, kd, *B, n]: the grouped digit D_g's residue mod EVERY
    dst prime, D_g + alpha*q_Jg = sum_j y_j * (q_Jg/q_j) (exact-gadget
    overflow; context.ks_group_conv_tables)."""
    kq = y.shape[0]
    primes_l = ctx.params.q_primes[:kq]
    omega = _omega(ctx)
    cw = jnp.asarray(_context.ks_group_conv_tables(tuple(primes_l), omega))
    kd = cw.shape[1]
    pad = kd * omega - kq
    if pad:
        y = jnp.concatenate(
            [y, jnp.zeros((pad, *y.shape[1:]), y.dtype)], axis=0)
    yg = y.reshape(kd, omega, *y.shape[1:])             # [kd, w, *B, n]
    tb = _tb(ctx, level)
    extra = (1,) * (y.ndim - 1)                         # *B dims + n
    prod = mm.mul_mod_barrett(
        yg[None], cw.reshape(kq, kd, omega, *extra),
        tb.p.reshape(kq, 1, 1, *extra),
        tb.mu.reshape(kq, 1, 1, *extra))                # [kq, kd, w, *B, n]
    return mm.add_mod_tree(
        prod, tb.p.reshape(kq, 1, 1, *extra), axis=2)[:, :, 0]


def to_ntt(ctx: SchemeContext, ct: Ciphertext) -> Ciphertext:
    if ct.is_ntt_form:
        return ct
    return ct.replace(data=_fwd_q(ctx, ct.data, ct.level), is_ntt_form=True)


def to_coeff(ctx: SchemeContext, ct: Ciphertext) -> Ciphertext:
    if not ct.is_ntt_form:
        return ct
    return ct.replace(data=_inv_q(ctx, ct.data, ct.level), is_ntt_form=False)


def _lift_plain(ctx: SchemeContext, pt: Plaintext, level: int = 0) -> jax.Array:
    """pt coeffs mod t (< t < every q_i) viewed as residues: [k, 1, n]."""
    k = ctx.k - level
    return jnp.broadcast_to(pt.data[None, None, :], (k, 1, ctx.n)).astype(jnp.uint32)


def _scale_by_delta(ctx: SchemeContext, pt: Plaintext, level: int = 0) -> jax.Array:
    """Delta_L * m as residues [k-L, 1, n] (encrypt path, src/fhe.cu:156);
    Delta_L = floor(q_L/t) at the ciphertext's level."""
    lifted = _lift_plain(ctx, pt, level)
    delta, delta_sh = ctx.delta_levels[level]
    return mm.mul_mod_shoup(
        lifted,
        delta[:, None, None],
        delta_sh[:, None, None],
        _p3(_tb(ctx, level)),
    )


# ---------------------------------------------------------------------------
# key generation (reference src/fhe.cu:54-111, SURVEY.md §3.2)
# ---------------------------------------------------------------------------


def keygen(ctx: SchemeContext, key: jax.Array) -> tuple[PublicKey, SecretKey]:
    """RLWE keypair: pk = (e - a*s, a) in NTT form, s ternary."""
    p = ctx.params
    tb = ctx.ntt_q
    k_s, k_a, k_e = jax.random.split(key, 3)
    s = sampling.ternary_rns(k_s, tb.p, 1, p.n, p.security.hamming_weight)
    a = sampling.uniform_rns(k_a, tb.p, tb.mu, 1, p.n)
    e = sampling.gaussian_rns(k_e, tb.p, p.security.sigma, 1, p.n)
    s_ntt = _fwd_q(ctx, s)
    a_ntt = _fwd_q(ctx, a)
    e_ntt = _fwd_q(ctx, e)
    b_ntt = mm.sub_mod(e_ntt, _ntt.pointwise_mul(a_ntt, s_ntt, tb), _p3(tb))
    pk = PublicKey(data=jnp.concatenate([b_ntt, a_ntt], axis=1))
    return pk, SecretKey(data=s_ntt)


def _keyswitch_keygen(ctx: SchemeContext, key: jax.Array, sk: SecretKey,
                      target_ntt: jax.Array,
                      t_scale_error: bool = False) -> jax.Array:
    """Keys encrypting (q/q_j) * target per RNS digit j.

    target_ntt: [k, 1, n] the secret-dependent polynomial to switch onto s
    (s^2 for relin, s(x^g) for Galois).  Returns [k_digits, k, 2, n] NTT form.

    RNS counterpart of the reference's base-2^w loop (src/fhe.cu:76-111):
    the decomposition base is the RNS prime basis itself.  t_scale_error=True
    produces BGV keys (error t*e, preserving the LSB plaintext slot) — the
    only difference between the schemes' key material."""
    p = ctx.params
    tb = ctx.ntt_q
    k = ctx.k
    n = p.n
    # W_d = (q/q_{J_d}) mod q_i table, exact on host.  J_d is the d-th
    # gadget group of ks_omega primes (omega=1: the classic per-prime
    # gadget, J_d = {q_d}); see context.ks_group_conv_tables for the
    # grouped-digit math.
    q = p.q
    omega = _omega(ctx)
    kd = -(-k // omega)
    w = np.zeros((kd, k), dtype=np.uint32)
    for d in range(kd):
        qJ = math.prod(p.q_primes[d * omega: min((d + 1) * omega, k)])
        for i, pi in enumerate(p.q_primes):
            w[d, i] = (q // qJ) % pi
    w = jnp.asarray(w)
    keys = []
    for j in range(kd):
        key, k_a, k_e = jax.random.split(key, 3)
        a = sampling.uniform_rns(k_a, tb.p, tb.mu, 1, n)
        e = sampling.gaussian_rns(k_e, tb.p, p.security.sigma, 1, n)
        if t_scale_error:
            e = _poly.mul_scalar(e, p.t, tb)
        a_ntt = _fwd_q(ctx, a)
        e_ntt = _fwd_q(ctx, e)
        w_target = mm.mul_mod_barrett(
            w[j][:, None, None], target_ntt, _p3(tb), tb.mu[:, None, None])
        b_ntt = mm.add_mod(
            mm.sub_mod(e_ntt, _ntt.pointwise_mul(a_ntt, sk.data, tb), _p3(tb)),
            w_target,
            _p3(tb),
        )
        keys.append(jnp.concatenate([b_ntt, a_ntt], axis=1))
    return jnp.stack(keys)  # [kd, k, 2, n]


def relinkey_gen(ctx: SchemeContext, key: jax.Array, sk: SecretKey) -> RelinKeys:
    """Keys for s^2 -> s switching (reference src/fhe.cu:76-111)."""
    tb = ctx.ntt_q
    s2 = _ntt.pointwise_mul(sk.data, sk.data, tb)
    return RelinKeys(data=_keyswitch_keygen(ctx, key, sk, s2))


def galoiskey_gen(ctx: SchemeContext, key: jax.Array, sk: SecretKey,
                  elements=None) -> GaloisKeys:
    """Keys for s(x^g) -> s switching, default power-of-two rotation set
    (reference declared-only galoiskey_gen, include/fhe.cuh:86)."""
    tb = ctx.ntt_q
    elements = tuple(elements) if elements is not None else tuple(ctx.galois_src.keys())
    s_coeff = _inv_q(ctx, sk.data)
    out = {}
    for g in elements:
        key, sub = jax.random.split(key)
        s_g = _apply_galois_coeff(ctx, s_coeff, g)
        s_g_ntt = _fwd_q(ctx, s_g)
        out[g] = _keyswitch_keygen(ctx, sub, sk, s_g_ntt)
    return GaloisKeys(data=out)


# ---------------------------------------------------------------------------
# encrypt / decrypt (reference src/fhe.cu:138-185, SURVEY.md §3.3/§3.5)
# ---------------------------------------------------------------------------


def encrypt(ctx: SchemeContext, key: jax.Array, pk: PublicKey,
            pt: Plaintext) -> Ciphertext:
    """ct = (pk0*u + e1 + Delta*m, pk1*u + e2), coefficient domain."""
    p = ctx.params
    tb = ctx.ntt_q
    k_u, k_e1, k_e2 = jax.random.split(key, 3)
    u = sampling.ternary_rns(k_u, tb.p, 1, p.n, p.security.hamming_weight)
    e1 = sampling.gaussian_rns(k_e1, tb.p, p.security.sigma, 1, p.n)
    e2 = sampling.gaussian_rns(k_e2, tb.p, p.security.sigma, 1, p.n)
    pk_u = _pk_u_product(ctx, u, pk)  # [k, 2, n] coeff (pk0*u, pk1*u)
    c0 = mm.add_mod(
        mm.add_mod(pk_u[:, :1], e1, _p3(tb)), _scale_by_delta(ctx, pt), _p3(tb))
    c1 = mm.add_mod(pk_u[:, 1:], e2, _p3(tb))
    return Ciphertext(
        data=jnp.concatenate([c0, c1], axis=1),
        level=0,
        is_ntt_form=False,
        noise_budget=_fresh_noise_budget(ctx),
    )


def decrypt(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey) -> Plaintext:
    """m = round(t/q * [ct(s)]_q) mod t via the exact gamma-trick scaling
    (the reference's decrypt called an undefined kernel, src/fhe.cu:181-184)."""
    x = _phase(ctx, ct, sk)
    m = _rns.decrypt_scale(x[:, None, :], ctx.dec_levels[ct.level],
                           fermat=ctx.params.t == 65537)
    return Plaintext(data=m[0])


def encrypt_batch(ctx: SchemeContext, key: jax.Array, pk: PublicKey,
                  pts: list) -> list:
    """Encrypt B plaintexts; element i is encrypt(ctx, fold_in(key, i), pk,
    pts[i]), a fresh encryption with independent randomness."""
    return [encrypt(ctx, jax.random.fold_in(key, i), pk, pt)
            for i, pt in enumerate(pts)]


def decrypt_batch(ctx: SchemeContext, cts: list, sk: SecretKey) -> list:
    """Decrypt B ciphertexts; element i == decrypt(cts[i])."""
    return [decrypt(ctx, ct, sk) for ct in cts]


def _phase(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey) -> jax.Array:
    """[k, n] coefficient-domain c0 + c1*s + c2*s^2 + ... mod q."""
    ct = to_coeff(ctx, ct)
    tb = _tb(ctx, ct.level)
    k = ctx.k - ct.level
    sk_l = sk.data[:k]
    comps = ct.data  # [k, c, n]
    c = comps.shape[1]
    acc = comps[:, 0]
    s_pow = sk_l  # s^1 in NTT form
    for idx in range(1, c):
        term = _inv_q(ctx, _ntt.pointwise_mul(
            _fwd_q(ctx, comps[:, idx:idx + 1], ct.level), s_pow, tb),
            ct.level)[:, 0]
        acc = mm.add_mod(acc, term, tb.p[:, None])
        if idx + 1 < c:
            s_pow = _ntt.pointwise_mul(s_pow, sk_l, tb)
    return acc


# ---------------------------------------------------------------------------
# additive ops (reference src/fhe.cu:187-197; declared add_plain/sub/sub_plain)
# ---------------------------------------------------------------------------


def _check_compat(a: Ciphertext, b: Ciphertext):
    if a.level != b.level or a.is_ntt_form != b.is_ntt_form:
        raise ValueError("ciphertext level/domain mismatch")


def add(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """Component-wise ring add, routed through the L4 poly layer (one
    implementation of ring arithmetic: scheme -> ops/poly -> ops/modmath)."""
    _check_compat(a, b)
    tb = _tb(ctx, a.level)
    return a.replace(
        data=_poly.add(a.data, b.data, tb),
        noise_budget=_b_of(ctx, a.level,
                           _noise.add(_v_of(ctx, a), _v_of(ctx, b))),
    )


def sub(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_compat(a, b)
    tb = _tb(ctx, a.level)
    return a.replace(
        data=_poly.sub(a.data, b.data, tb),
        noise_budget=_b_of(ctx, a.level,
                           _noise.add(_v_of(ctx, a), _v_of(ctx, b))),
    )


def add_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    """c0 += Delta_L * m (slot/coeff semantics preserved, any level).

    NTT-form residency (reference include/fhe.cuh:68 `is_ntt_form`): an
    eval-domain ciphertext stays eval-domain — the
    Delta-scaled plaintext is forward-transformed (one [k, 1, n] NTT, far
    cheaper than the INTT+NTT round trip of the whole 2-component ct)."""
    tb = _tb(ctx, ct.level)
    op = _scale_by_delta(ctx, pt, ct.level)
    if ct.is_ntt_form:
        op = _fwd_q(ctx, op, ct.level)
    c0 = _poly.add(ct.data[:, :1], op, tb)
    return ct.replace(data=jnp.concatenate([c0, ct.data[:, 1:]], axis=1))


def sub_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    tb = _tb(ctx, ct.level)
    op = _scale_by_delta(ctx, pt, ct.level)
    if ct.is_ntt_form:
        op = _fwd_q(ctx, op, ct.level)
    c0 = _poly.sub(ct.data[:, :1], op, tb)
    return ct.replace(data=jnp.concatenate([c0, ct.data[:, 1:]], axis=1))


def plain_ntt_operand(ctx: SchemeContext, pt: Plaintext,
                      level: int = 0) -> jax.Array:
    """NTT-form multiply_plain operand [k-L, 1, n] — precompute once and
    pass to multiply_plain(pt_ntt=...) when a plaintext is reused across
    many products (the reference's NTT-form operand caching idea,
    include/fhe.cuh:68; the FHE wrapper caches this per (pt, level))."""
    return _fwd_q(ctx, _lift_plain(ctx, pt, level), level)


def multiply_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext,
                   pt_ntt: jax.Array | None = None) -> Ciphertext:
    """c_i *= m (negacyclic), no rescale: ct(s)*m = Delta*(m1*m) + v*m.

    Residency: an NTT-form input yields an NTT-form output with ZERO
    transforms when pt_ntt (see plain_ntt_operand) is supplied — the
    pattern for plaintext dot products: to_ntt once, multiply/accumulate
    in eval domain, to_coeff once at the boundary."""
    tb = _tb(ctx, ct.level)
    ct_ntt = to_ntt(ctx, ct)
    if pt_ntt is None:
        pt_ntt = plain_ntt_operand(ctx, pt, ct.level)
    data = _ntt.pointwise_mul(
        ct_ntt.data, jnp.broadcast_to(pt_ntt, ct_ntt.data.shape), tb)
    out = ct_ntt.replace(
        data=data,
        noise_budget=_b_of(ctx, ct.level, _noise.multiply_plain(
            ctx.params, _v_of(ctx, ct))),
    )
    return to_coeff(ctx, out) if not ct.is_ntt_form else out


# ---------------------------------------------------------------------------
# multiply + relinearize (the benchmark path, SURVEY.md §3.4)
# ---------------------------------------------------------------------------


def _tensor_product(ctx: SchemeContext, x: jax.Array, y: jax.Array, tb,
                    fwd, inv) -> jax.Array:
    """(c0, c1, c2) = x (x) y for 2-component [k, 2, n] operands.  Both
    operands ride ONE forward transform call ([k, 4, n]) — the batch axis
    amortizes the kernel's fixed cost.  Shared by the BFV and BGV multiplies."""
    xy = fwd(ctx, jnp.concatenate([x, y], axis=1))
    xf, yf = xy[:, :2], xy[:, 2:]
    p = _p3(tb)
    c0 = _ntt.pointwise_mul(xf[:, :1], yf[:, :1], tb)
    c2 = _ntt.pointwise_mul(xf[:, 1:], yf[:, 1:], tb)
    c1 = mm.add_mod(
        _ntt.pointwise_mul(xf[:, :1], yf[:, 1:], tb),
        _ntt.pointwise_mul(xf[:, 1:], yf[:, :1], tb),
        p,
    )
    return inv(ctx, jnp.concatenate([c0, c1, c2], axis=1))


def _pk_u_product(ctx: SchemeContext, u: jax.Array, pk: PublicKey) -> jax.Array:
    """[k, 2, n] coeff-domain (pk0*u, pk1*u).  The single encrypt hot
    product, shared by BFV and BGV."""
    u_ntt = _fwd_q(ctx, u)
    return _inv_q(ctx, _ntt.pointwise_mul(
        jnp.broadcast_to(u_ntt, pk.data.shape), pk.data, ctx.ntt_q))


def _dispatch_tensor_product(ctx: SchemeContext, a_data: jax.Array,
                             b_data: jax.Array, level: int,
                             base: str = "q") -> jax.Array:
    """3-component coeff-domain ciphertext tensor product over the level-L
    `q` base or the BEHZ `bsk` base, on the engine the context selects
    (four-step matmul when use_mxu, else the stage-sweep NTT).

    BFV (both bases) and BGV (q base) multiply through here.  These are
    closed fwd -> pointwise -> inv loops (no stored NTT-form data enters),
    so the four-step engine — whose evaluation ORDER differs from the CT
    engine — is a drop-in."""
    assert base in ("q", "bsk")
    if ctx.use_mxu:
        from ..ops import ntt_mxu as _ntt_mxu
        tbm = (_ntt_mxu.slice_tables(ctx.ntt_q_mxu, ctx.k - level)
               if base == "q" else _ntt_mxu.slice_tables_last(
                   ctx.ntt_bsk_mxu, ctx.bsk_counts[level]))
        fwd = lambda c, x: _ntt_mxu.ntt_forward(x, tbm)
        inv = lambda c, x: _ntt_mxu.ntt_inverse(x, tbm)
    elif base == "q":
        fwd = lambda c, x: _fwd_q(c, x, level)
        inv = lambda c, x: _inv_q(c, x, level)
    else:
        fwd = lambda c, x: _fwd_bsk(c, x, level)
        inv = lambda c, x: _inv_bsk(c, x, level)
    tb = _tb(ctx, level) if base == "q" else _tb_bsk(ctx, level)
    return _tensor_product(ctx, a_data, b_data, tb, fwd, inv)


def multiply_no_relin(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """BEHZ RNS tensor product + t/q_L scaling -> 3-component ciphertext,
    at any level (per-level BEHZ constants from the context).

    Bit-exact with oracle.behz_multiply_no_relin at level 0.  Replaces the
    reference's multiply (src/fhe.cu:199-224) whose scaling step didn't exist."""
    if a.level != b.level:
        raise ValueError("ciphertext level mismatch")
    if a.num_components != 2 or b.num_components != 2:
        raise ValueError(
            "multiply needs 2-component ciphertexts; relinearize first "
            f"(got {a.num_components} and {b.num_components})")
    level = a.level
    a = to_coeff(ctx, a)
    b = to_coeff(ctx, b)
    tb_q, tb_bsk = _tb(ctx, level), _tb_bsk(ctx, level)
    smq = ctx.smq_levels[level]

    # Step 1: centered lift of all 4 components into Bsk.
    lift_a = _rns.sm_mrq(a.data, smq)   # [l+1, 2, n]
    lift_b = _rns.sm_mrq(b.data, smq)
    # Steps 2+3: tensor products in both bases, scaled by t.
    tens_q = _dispatch_tensor_product(ctx, a.data, b.data, level)
    tens_bsk = _dispatch_tensor_product(ctx, lift_a, lift_b, level,
                                        base="bsk")
    t_mod_q = ctx.dec_c.t  # t < every prime: same residue everywhere
    tx_q = mm.mul_mod_barrett(
        tens_q, jnp.broadcast_to(t_mod_q, tens_q.shape), _p3(tb_q),
        tb_q.mu[:, None, None])
    tx_bsk = mm.mul_mod_barrett(
        tens_bsk, jnp.broadcast_to(t_mod_q, tens_bsk.shape), _p3(tb_bsk),
        tb_bsk.mu[:, None, None])
    floored = _rns.fast_floor(tx_q, tx_bsk, ctx.floor_levels[level])
    # Step 4: exact conversion back to q_L.
    out = _rns.fast_bconv_sk(floored, ctx.sk_levels[level])  # [k-L,3,n]
    return Ciphertext(
        data=out, level=level, is_ntt_form=False,
        noise_budget=_b_of(ctx, level, _noise.bfv_multiply(
            ctx.params, _v_of(ctx, a), _v_of(ctx, b))),
    )


def _switch_keys_down(ctx: SchemeContext, ks_keys: jax.Array, level: int,
                      bgv: bool = False) -> jax.Array:
    """Mod-switch level-0 key-switching keys to a deeper level.

    key_j encrypts (q/q_j)*target mod q; rounding-switching it down L primes
    yields an encryption of exactly (q_L/q_j)*target mod q_L (the gadget
    coefficient divides exactly for the surviving digits j < k-L) plus small
    rounding noise.  For BGV keys the t-corrected switch preserves the
    t*e error structure.  Input/output NTT form; [k,k,2,n] -> [k-L,k-L,2,n]."""
    if level == 0:
        return ks_keys
    k = ctx.k
    kl = k - level
    omega = _omega(ctx)
    if omega > 1 and kl % omega:
        raise ValueError(
            f"ks_omega={omega} keys cannot be switched to level {level} "
            f"({kl} surviving primes is not a whole number of gadget "
            f"groups); use an aligned level or omega=1 keys")
    kd_l = kl // omega if omega > 1 else kl
    # ks_keys is [digit d, prime i, 2, n]; keep the surviving digit groups
    # (their gadget coefficient divides exactly: (q/q_Jd)/dropped = q_L/q_Jd)
    # and put the prime axis first for the RNS switch: [k_primes, kd_l*2, n]
    flat = jnp.transpose(ks_keys[:kd_l], (1, 0, 2, 3)).reshape(
        k, kd_l * 2, ctx.n)
    coeff = _inv_q(ctx, flat)
    for lvl in range(level):
        mc = ctx.bgv_mod_switch[lvl] if bgv else ctx.mod_switch[lvl]
        coeff = (_rns.bgv_mod_switch_drop_last(coeff, mc) if bgv
                 else _rns.mod_switch_drop_last(coeff, mc))
    switched = _fwd_q(ctx, coeff, level)               # [k-L, kd_l*2, n]
    return jnp.transpose(
        switched.reshape(kl, kd_l, 2, ctx.n), (1, 0, 2, 3))


def switch_relin_keys(ctx: SchemeContext, rlk: RelinKeys, level: int,
                      bgv: bool = False) -> RelinKeys:
    """Precompute level-L relinearization keys from level-0 keys (see
    _switch_keys_down).  Callers doing repeated leveled relinearizations
    should cache the result (FHE wrapper does this automatically).

    BGV keys must pass bgv=True (or use scheme.bgv.switch_relin_keys): the
    plain rounding switch would break their t*e error structure without any
    shape error — decryptions would silently be wrong."""
    return RelinKeys(data=_switch_keys_down(ctx, rlk.data, level, bgv))


def relinearize(ctx: SchemeContext, ct: Ciphertext, rlk: RelinKeys,
                bgv: bool = False, keys_at_level: bool = False) -> Ciphertext:
    """3 -> 2 components via RNS-digit key switching at any level (real
    implementation; the reference's relinearize just truncated,
    src/fhe.cu:226-235).  keys_at_level=True skips the on-the-fly key
    down-switch (rlk already produced by switch_relin_keys)."""
    assert ct.num_components == 3
    level = ct.level
    ct = to_coeff(ctx, ct)
    c2 = ct.data[:, 2]  # [k-L, n]
    keys = (rlk.data if keys_at_level
            else _switch_keys_down(ctx, rlk.data, level, bgv))
    tb = _tb(ctx, level)
    p = _p3(tb)
    delta = _keyswitch_delta(ctx, c2, keys, level)
    out = mm.add_mod(ct.data[:, :2], delta, p)
    return ct.replace(data=out, noise_budget=_b_of(
        ctx, level,
        _noise.add(_v_of(ctx, ct), _noise.keyswitch_add(ctx.params, level))))


def _digits_ntt(ctx: SchemeContext, poly: jax.Array, level: int) -> jax.Array:
    """RNS-gadget decomposition of a component, NTT'd: [k-L, n] coeff ->
    [k_primes, k_digits, n] NTT form.  This is the expensive half of a key
    switch; hoisted rotations share ONE of these across many automorphisms.
    ks_omega > 1 groups omega primes per digit (k_digits = ceil(kq/omega)),
    halving the digit transforms and key inner products at omega = 2."""
    tb = _tb(ctx, level)
    inv_qhat, inv_qhat_sh = ctx.inv_qhat_levels[level]
    # digits: D_j = [poly_j * (q_L/q_j)^-1]_{q_j}  -> [k-L, n]
    d = mm.mul_mod_shoup(
        poly, inv_qhat[:, None], inv_qhat_sh[:, None], tb.p[:, None])
    if _omega(ctx) > 1:
        d_all = _grouped_digit_residues(ctx, d, level)  # [kq, kd, n]
    else:
        # broadcast digit j to every prime i (reduce D_j mod q_i):
        # [k_primes, k_digits, n]
        d_all = mm.barrett_reduce_u32(
            d[None, :, :], tb.p[:, None, None], tb.mu[:, None, None])
    return _fwd_q(ctx, d_all, level)  # digits as batch axis


def _ks_inner_from_digits(ctx: SchemeContext, d_ntt: jax.Array,
                          ks_keys: jax.Array, level: int):
    """Inner product of decomposed digits with key material.

    One batched pointwise multiply over the digit axis, then a balanced
    mod-add tree: [k, kd, 1, n] x [k, kd, 2, n] -> [k, 2, n] (round-1
    review item 6: the serial per-digit loop was O(k) adds on the critical
    path — at the reference's k = 8 throughput config this fuses the 2k^2
    products into one op and log2(k) add sweeps)."""
    tb = _tb(ctx, level)
    kt = jnp.transpose(ks_keys, (1, 0, 2, 3))  # [k_primes, k_digits, 2, n]
    p4 = tb.p[:, None, None, None]
    prod = mm.mul_mod_barrett(
        d_ntt[:, :, None, :], kt, p4, tb.mu[:, None, None, None])
    acc = mm.add_mod_tree(prod, p4, axis=1)[:, 0]  # [k-L, 2, n]
    return acc[:, 0:1], acc[:, 1:2]


def _keyswitch_inner(ctx: SchemeContext, poly: jax.Array, ks_keys: jax.Array,
                     level: int = 0):
    """Key-switch inner product: sum_j NTT(D_j) * key_j over RNS digits.

    poly: [k-L, n] coeff domain (the component being switched).
    ks_keys: [k-L, k-L, 2, n] NTT form at the same level.
    Returns (acc0, acc1) each [k-L, 1, n] NTT.

    The psum over digits is the collective the multi-chip path distributes
    (SURVEY.md §2 parallelism table, key-switch inner products)."""
    return _ks_inner_from_digits(
        ctx, _digits_ntt(ctx, poly, level), ks_keys, level)


def _keyswitch_delta(ctx: SchemeContext, poly: jax.Array, ks_keys: jax.Array,
                     level: int = 0) -> jax.Array:
    """Coefficient-domain key-switch correction INTT(sum_j NTT(D_j) ⊙ key_j)
    as one [k-L, 2, n] tensor — the whole relin/rotation critical path."""
    acc0, acc1 = _keyswitch_inner(ctx, poly, ks_keys, level)
    return _inv_q(ctx, jnp.concatenate([acc0, acc1], axis=1), level)


def multiply(ctx: SchemeContext, a: Ciphertext, b: Ciphertext,
             rlk: RelinKeys, keys_at_level: bool = False) -> Ciphertext:
    """Full homomorphic multiply: tensor + scale + relinearize
    (reference src/fhe.cu:199-224)."""
    return relinearize(ctx, multiply_no_relin(ctx, a, b), rlk,
                       keys_at_level=keys_at_level)


def multiply_batch(ctx: SchemeContext, cts_a: list, cts_b: list,
                   rlk: RelinKeys, keys_at_level: bool = False) -> list:
    """B independent multiply+relinearize ops; element i ==
    multiply(ctx, cts_a[i], cts_b[i], rlk)."""
    if len(cts_a) != len(cts_b) or not cts_a:
        raise ValueError("multiply_batch needs equal-length non-empty lists")
    level = cts_a[0].level
    if any(ct.level != level for ct in cts_a + cts_b):
        raise ValueError("multiply_batch: all ciphertexts at one level")
    return [multiply(ctx, a, b, rlk, keys_at_level)
            for a, b in zip(cts_a, cts_b)]


# ---------------------------------------------------------------------------
# key switching / galois rotations (declared-only in the reference)
# ---------------------------------------------------------------------------


def key_switch(ctx: SchemeContext, ct: Ciphertext, ks_keys: jax.Array,
               bgv: bool = False, keys_at_level: bool = False) -> Ciphertext:
    """Switch a 2-component ct encrypted under s' to one under s, where
    ks_keys encrypt (q/q_j)*s' (reference decl include/fhe.cuh:134-135).
    Level-0 keys are switched down automatically for deeper ciphertexts
    (keys_at_level=True skips that — ks_keys already at ct.level)."""
    assert ct.num_components == 2
    level = ct.level
    ct = to_coeff(ctx, ct)
    tb = _tb(ctx, level)
    p = _p3(tb)
    keys = ks_keys if keys_at_level else _switch_keys_down(
        ctx, ks_keys, level, bgv)
    delta = _keyswitch_delta(ctx, ct.data[:, 1], keys, level)
    c0 = mm.add_mod(ct.data[:, :1], delta[:, :1], p)
    return ct.replace(data=jnp.concatenate([c0, delta[:, 1:]], axis=1))


def _galois_coeff_folded(data: jax.Array, ft, p) -> jax.Array:
    """Apply the folded-affine automorphism factorization (see
    context.galois_fold_tables) to [..., n] data; p broadcastable to the
    folded [..., R, L] shape."""
    if len(ft) == 6:
        # two-level recursion: the L-length gather folds again to [R2, L2]
        # (one short gather + row rolls at each level)
        t_b2, t_a2, t_a, rho, rho2, neg3 = ft
        R, R2 = rho.shape[0], rho2.shape[0]
        L2 = t_b2.shape[0]
        x = data.reshape(*data.shape[:-1], R, R2, L2)
        y = jnp.take(x, t_b2, axis=-1)     # lane gather, L2-length index
        w = y                              # level-2 row rotation by t_a2
        for r in range(1, R2):
            w = jnp.where(t_a2 == r, jnp.roll(y, -r, axis=-2), w)
        z = jnp.take(w, rho2, axis=-2)     # level-2 static row shuffle
        w1 = z                             # level-1 rotation by t_a [R2, L2]
        for r in range(1, R):
            w1 = jnp.where(t_a == r, jnp.roll(z, -r, axis=-3), w1)
        z1 = jnp.take(w1, rho, axis=-3)    # level-1 static row shuffle
        out = jnp.where(neg3, mm.neg_mod(z1, p[..., None]), z1)
        return out.reshape(data.shape)
    t_b, t_a, rho, neg2 = ft
    R = rho.shape[0]
    L = t_b.shape[0]
    x = data.reshape(*data.shape[:-1], R, L)
    y = jnp.take(x, t_b, axis=-1)          # lane gather, L-length index
    w = y                                  # per-column row rotation by t_a
    for r in range(1, R):
        w = jnp.where(t_a == r, jnp.roll(y, -r, axis=-2), w)
    z = jnp.take(w, rho, axis=-2)          # static row shuffle
    out = jnp.where(neg2, mm.neg_mod(z, p), z)
    return out.reshape(data.shape)


def _apply_galois_coeff(ctx: SchemeContext, data: jax.Array, g: int) -> jax.Array:
    """a(x) -> a(x^g) on [k, B, n] coefficient-domain residues.

    n >= 1024 uses the folded-affine factorization (one short gather +
    row rolls + a static row shuffle, context.galois_fold_tables); smaller
    rings use the cached full-permutation gather.  Any odd g works,
    including elements outside the precomputed default set."""
    g = int(g)
    p = ctx.ntt_q.p[: data.shape[0], None, None]
    ft = _context.galois_fold_tables(ctx.n, g)
    if ft is not None:
        return _galois_coeff_folded(data, ft, p[..., None])
    if g in ctx.galois_src:
        src, neg = ctx.galois_src[g], ctx.galois_neg[g]
    else:
        src, neg = _context.galois_perm_tables(ctx.n, g)
    gathered = jnp.take(data, src, axis=-1)
    return jnp.where(neg[None, None, :], mm.neg_mod(gathered, p), gathered)


def switch_galois_keys(ctx: SchemeContext, gal_keys: GaloisKeys, level: int,
                       bgv: bool = False) -> GaloisKeys:
    """Precompute level-L Galois keys from level-0 keys (cacheable; the FHE
    wrapper does this per (keys, level)).  BGV keys need bgv=True."""
    return GaloisKeys(data={
        g: _switch_keys_down(ctx, arr, level, bgv)
        for g, arr in gal_keys.data.items()})


def apply_galois(ctx: SchemeContext, ct: Ciphertext, g: int,
                 gal_keys: GaloisKeys, bgv: bool = False,
                 keys_at_level: bool = False) -> Ciphertext:
    """Automorphism + key switch (building block of rotate_rows/columns)."""
    assert ct.num_components == 2
    ct = to_coeff(ctx, ct)
    permuted = _apply_galois_coeff(ctx, ct.data, g)
    tmp = ct.replace(data=permuted)
    return key_switch(ctx, tmp, gal_keys.data[g], bgv, keys_at_level).replace(
        noise_budget=_b_of(
            ctx, ct.level,
            _noise.add(_noise.galois(_v_of(ctx, ct)),
                       _noise.keyswitch_add(ctx.params, ct.level))))


def rotate_rows(ctx: SchemeContext, ct: Ciphertext, steps: int,
                gal_keys: GaloisKeys, bgv: bool = False,
                keys_at_level: bool = False) -> Ciphertext:
    """Cyclic slot rotation within each row of the 2 x (n/2) slot matrix
    (reference decl include/fhe.cuh:113-114).  Decomposes |steps| into the
    power-of-two Galois elements the default keys cover."""
    n = ctx.n
    m = 2 * n
    half = n // 2
    steps = steps % half
    if steps == 0:
        return ct
    bit = 1
    while steps:
        if steps & bit:
            g = pow(3, bit, m)
            if g not in gal_keys.data:
                raise KeyError(f"no galois key for element {g} (step {bit})")
            ct = apply_galois(ctx, ct, g, gal_keys, bgv, keys_at_level)
            steps ^= bit
        bit <<= 1
    return ct


def rotate_columns(ctx: SchemeContext, ct: Ciphertext,
                   gal_keys: GaloisKeys, bgv: bool = False,
                   keys_at_level: bool = False) -> Ciphertext:
    """Swap the two slot rows: g = 2n - 1 (reference decl include/fhe.cuh:115-116)."""
    return apply_galois(ctx, ct, 2 * ctx.n - 1, gal_keys, bgv, keys_at_level)


def apply_galois_batch(ctx: SchemeContext, cts: list, g: int,
                       gal_keys: GaloisKeys,
                       keys_at_level: bool = False) -> list:
    """The SAME automorphism applied to B independent ciphertexts; element
    i == apply_galois(cts[i], g)."""
    return [apply_galois(ctx, ct, g, gal_keys, False, keys_at_level)
            for ct in cts]


def rotate_rows_batch(ctx: SchemeContext, cts: list, steps: int,
                      gal_keys: GaloisKeys,
                      keys_at_level: bool = False) -> list:
    """rotate_rows over B independent ciphertexts, each power-of-two hop
    running one batched key switch (apply_galois_batch)."""
    n = ctx.n
    m = 2 * n
    steps = steps % (n // 2)
    bit = 1
    while steps:
        if steps & bit:
            g = pow(3, bit, m)
            if g not in gal_keys.data:
                raise KeyError(f"no galois key for element {g} (step {bit})")
            cts = apply_galois_batch(ctx, cts, g, gal_keys, keys_at_level)
            steps ^= bit
        bit <<= 1
    return cts


@functools.lru_cache(maxsize=None)
def _eval_perm_host(n: int, g: int):
    """NTT-domain form of the automorphism a(x) -> a(x^g): a pure gather.

    The merged-psi CT transform stores position j = evaluation at
    psi^(2*brv(j)+1); phi_g evaluates at the g-th powers, so
    out[j] = in[src[j]] with 2*brv(src[j])+1 = g*(2*brv(j)+1) mod 2n.
    No sign flips — the negacyclic wrap bookkeeping only exists in the
    coefficient representation."""
    from .. import primes as _primes_mod
    bits = n.bit_length() - 1
    idx = np.empty(n, dtype=np.int32)
    for j in range(n):
        e = (g * (2 * _primes_mod.bit_reverse(j, bits) + 1)) % (2 * n)
        idx[j] = _primes_mod.bit_reverse((e - 1) // 2, bits)
    return idx


def apply_galois_hoisted(ctx: SchemeContext, ct: Ciphertext, elements,
                         gal_keys: GaloisKeys, bgv: bool = False,
                         keys_at_level: bool = False) -> list[Ciphertext]:
    """Many automorphisms of ONE ciphertext sharing a single gadget
    decomposition ("hoisting", SEAL/HElib-style) — the digit decomposition
    + its k NTTs are computed once; each element then costs only an
    NTT-domain gather, the key inner product, and one inverse transform.

    Equivalent to apply_galois per element: the rotated digit vector
    phi_g(D_j(c1)) is a valid gadget decomposition of phi_g(c1) (phi_g is a
    ring automorphism, so sum_j phi_g(D_j) W_j = phi_g(c1) mod q) with the
    same digit magnitudes — outputs decrypt identically with identical
    noise scale, though not bit-identically (sign-flipped coefficients
    carry the -d rather than q_j - d representative).

    Returns one rotated ciphertext per Galois element, in order."""
    assert ct.num_components == 2
    level = ct.level
    ct = to_coeff(ctx, ct)
    tb = _tb(ctx, level)
    p = _p3(tb)
    d_ntt = _digits_ntt(ctx, ct.data[:, 1], level)     # hoisted: ONCE
    nb = _b_of(ctx, level,
               _noise.add(_noise.galois(_v_of(ctx, ct)),
                          _noise.keyswitch_add(ctx.params, level)))
    keys_per_g = [
        gal_keys.data[g] if keys_at_level
        else _switch_keys_down(ctx, gal_keys.data[g], level, bgv)
        for g in elements]
    outs = []
    for g, keys in zip(elements, keys_per_g):
        perm = jnp.asarray(_eval_perm_host(ctx.n, int(g)))
        dg = jnp.take(d_ntt, perm, axis=-1)            # NTT-domain phi_g
        acc0, acc1 = _ks_inner_from_digits(ctx, dg, keys, level)
        delta = _inv_q(ctx, jnp.concatenate([acc0, acc1], axis=1), level)
        c0 = mm.add_mod(
            _apply_galois_coeff(ctx, ct.data[:, :1], g), delta[:, :1], p)
        outs.append(ct.replace(
            data=jnp.concatenate([c0, delta[:, 1:]], axis=1),
            noise_budget=nb))
    return outs


def apply_galois_hoisted_sum(ctx: SchemeContext, ct: Ciphertext, elements,
                             gal_keys: GaloisKeys, bgv: bool = False,
                             keys_at_level: bool = False) -> Ciphertext:
    """ct + sum_e apply_galois(ct, e) through one hoisted decomposition —
    the inner-sum (sum_slots) stage.  Decrypt-equal to composing
    apply_galois with adds."""
    assert ct.num_components == 2
    level = ct.level
    ct = to_coeff(ctx, ct)
    p = _p3(_tb(ctx, level))
    # noise: base + B rotated terms, each with one key-switch add
    v = _v_of(ctx, ct)
    v_rot = _noise.add(_noise.galois(v),
                       _noise.keyswitch_add(ctx.params, level))
    acc_v = v
    for _ in elements:
        acc_v = _noise.add(acc_v, v_rot)
    data = ct.data
    for o in apply_galois_hoisted(ctx, ct, elements, gal_keys, bgv,
                                  keys_at_level):
        data = mm.add_mod(data, o.data, p)
    return ct.replace(data=data, noise_budget=_b_of(ctx, level, acc_v))


def apply_galois_hoisted_batch(ctx: SchemeContext, cts: list, elements,
                               gal_keys: GaloisKeys, bgv: bool = False,
                               keys_at_level: bool = False
                               ) -> list[list[Ciphertext]]:
    """Hoisted rotations for C independent ciphertexts: outs[c][e] ==
    apply_galois(cts[c], elements[e]) up to digit representatives
    (decrypt-identical, same noise; see apply_galois_hoisted)."""
    return [apply_galois_hoisted(ctx, ct, elements, gal_keys, bgv,
                                 keys_at_level) for ct in cts]


# ---------------------------------------------------------------------------
# modulus switching + bootstrap pipeline (declared-only in the reference)
# ---------------------------------------------------------------------------


def mod_switch_to_next(ctx: SchemeContext, ct: Ciphertext) -> Ciphertext:
    """Drop one RNS prime with exact rounding (reference decl
    include/fhe.cuh:109; kernel poly_mod_switch_kernel never existed)."""
    ct = to_coeff(ctx, ct)
    if ct.level >= ctx.k - 1:
        raise ValueError("already at the last level")
    mc = ctx.mod_switch[ct.level]
    new = _rns.mod_switch_drop_last(ct.data, mc)
    # q shrinks by q_last but the noise divides by q_last too: the budget is
    # roughly preserved minus the rounding term (variance model).
    v = _noise.bfv_mod_switch(ctx.params, ct.level, _v_of(ctx, ct))
    return ct.replace(data=new, level=ct.level + 1,
                      noise_budget=_b_of(ctx, ct.level + 1, v))


def mod_switch_to_level(ctx: SchemeContext, ct: Ciphertext, target: int) -> Ciphertext:
    while ct.level < target:
        ct = mod_switch_to_next(ctx, ct)
    return ct


def modulus_raise(ctx: SchemeContext, ct: Ciphertext) -> Ciphertext:
    """Approximate base extension back to the full q basis (bootstrap helper,
    reference decl include/fhe.cuh:140).  Introduces an alpha*q_level additive
    term absorbed as noise, like all fast-base-conversion raises."""
    if ct.level == 0:
        return ct
    ct = to_coeff(ctx, ct)
    src = ctx.params.q_primes[: ctx.k - ct.level]
    cc = _rns.make_base_conv(src, ctx.params.q_primes)
    return ct.replace(data=_rns.fast_base_conv(ct.data, cc), level=0)


def bootstrap(ctx: SchemeContext, key: jax.Array, ct: Ciphertext,
              sk: SecretKey, pk: PublicKey) -> Ciphertext:
    """Noise refresh.  The reference declares ``bootstrap(ct, sk)`` taking the
    *secret key* (include/fhe.cuh:119) — i.e. a trusted re-encryption refresh,
    not a public bootstrapping; we implement that declared contract:
    decrypt -> re-encrypt, recovering the fresh noise budget."""
    pt = decrypt(ctx, mod_switch_to_level(ctx, ct, 0) if ct.level else ct, sk)
    return encrypt(ctx, key, pk, pt)


# ---------------------------------------------------------------------------
# noise estimation (reference decl include/fhe.cuh:122)
# ---------------------------------------------------------------------------


def estimate_noise_budget(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey) -> float:
    """Exact remaining noise budget in bits: log2(q/(2t)) - log2(||v||_inf),
    computed host-side via CRT (the only big-int step, diagnostic only).

    Caveat: v is measured against the DECRYPTED plaintext.  Once the true
    noise exceeds the decryption bound, decryption flips to a wrong value
    and the residual against it can still be small — the estimate can read
    as a small positive number for an already-corrupted ciphertext.  Treat
    budgets under ~2 bits as unreliable (same semantics as the reference's
    declared sk-taking estimator, include/fhe.cuh:122)."""
    p = ctx.params
    level = ct.level
    primes_l = p.q_primes[: ctx.k - level]
    q = math.prod(primes_l)
    t = p.t
    x = np.asarray(_phase(ctx, ct, sk))  # [k, n]
    m = np.asarray(_rns.decrypt_scale(jnp.asarray(x)[:, None, :],
                                      ctx.dec_levels[level],
                                      fermat=p.t == 65537)[0])
    coeffs = _rns.from_rns_host(x, primes_l)
    delta = q // t
    worst = 1
    for j, c in enumerate(coeffs):
        v = (c - delta * int(m[j])) % q
        if v > q // 2:
            v = q - v
        worst = max(worst, v)
    return max(0.0, math.log2(q / (2 * t)) - math.log2(worst))


def exact_noise_budget(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey,
                       pt: Plaintext) -> float:
    """Noise budget measured against a KNOWN expected plaintext polynomial.

    Unlike estimate_noise_budget (which measures against whatever the
    ciphertext currently decrypts to, and therefore reads small-positive on
    an already-corrupted ciphertext — the round-1 fuzzer blind spot), this
    residual is taken against the caller's model plaintext and goes
    NEGATIVE once the true noise crosses the decryption bound.  Host-side
    CRT diagnostic; pt is the encoded polynomial (mod t coefficients).

    Aliasing caveat: residues mod q cannot distinguish noise v from v - q,
    so once the TRUE noise grows past q/2 the measurement wraps and may
    read as a small POSITIVE budget again (fuzz seed 4004).  A reading
    under ~1 bit is therefore "at or past exhaustion", not a guarantee of
    correct decryption; the tracked ct.noise_budget (which decays
    monotonically and pins at 0) disambiguates."""
    p = ctx.params
    level = ct.level
    primes_l = p.q_primes[: ctx.k - level]
    q = math.prod(primes_l)
    t = p.t
    x = np.asarray(_phase(ctx, ct, sk))
    coeffs = _rns.from_rns_host(x, primes_l)
    delta = q // t
    m = np.asarray(pt.data)
    worst = 1
    for j, c in enumerate(coeffs):
        v = (c - delta * int(m[j])) % q
        if v > q // 2:
            v = q - v
        worst = max(worst, v)
    return math.log2(q / (2 * t)) - math.log2(worst)
