"""BGV scheme on device — the second scheme of the reference's "BGV/BFV"
declaration (``include/fhe.cuh`` module docs, ``docs/ARCHITECTURE.md``
"Layer 5: FHE Scheme (BGV/BFV)"; the reference only ever implemented the BFV
formulas, this module supplies real BGV).

BGV places the plaintext in the least-significant position of the phase:

    phase = c0 + c1*s = m + t*e   (mod q)

so encryption adds ``t*e`` noise, multiplication is a *plain* tensor product
mod q (no rescaling — contrast BFV's BEHZ t/q scaling), decryption is the
exact centered reduction ``[phase]_q mod t`` (implemented with the BEHZ
m_tilde machinery, ops/rns.sm_mrq with destination base {t}), and noise is
managed by modulus switching with a mod-t correction
(ops/rns.bgv_mod_switch_drop_last).  Each dropped prime divides the
underlying plaintext by ``q_last mod t``; ciphertexts track the accumulated
``scale_t`` correction factor (SEAL-style) and decrypt multiplies it back.

Everything scheme-agnostic (key switching, Galois rotations, phase
computation, NTT-domain plumbing) is reused from scheme/bfv.py — the key
material has the same RNS-gadget shape, only the error term is t-scaled.

Bit-exact against fhe_jax.oracle.BGVOracle (tests/test_bgv_scheme.py).
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import modmath as mm
from ..ops import ntt as _ntt
from ..ops import poly as _poly
from ..ops import rns as _rns
from ..ops import sampling
from .context import SchemeContext
from . import noise as _noise
from .types import (Ciphertext, GaloisKeys, Plaintext, PublicKey, RelinKeys,
                    SecretKey)
from . import bfv as _bfv
from .bfv import (_fwd_q, _inv_q, _lift_plain, _p3, _phase, _tb, to_coeff,
                  to_ntt)

# re-exported scheme-agnostic ops (identical math for BGV key material)
key_switch = _bfv.key_switch
apply_galois = _bfv.apply_galois
apply_galois_hoisted = _bfv.apply_galois_hoisted
apply_galois_hoisted_batch = _bfv.apply_galois_hoisted_batch
apply_galois_hoisted_sum = _bfv.apply_galois_hoisted_sum


def _t_scale(ctx: SchemeContext, e: jax.Array, level: int = 0) -> jax.Array:
    """t * e mod q_i on [k, B, n] residues (L4 poly scalar multiply)."""
    return _poly.mul_scalar(e, ctx.params.t, _tb(ctx, level))


# -- scale_t plumbing (host int OR traced uint32 scalar; see types.Ciphertext)


def _host_scale(v):
    """Concrete integer value of a scale_t (python int, numpy scalar, or a
    concrete device scalar), or None if traced."""
    return None if isinstance(v, jax.core.Tracer) else int(v)


def _t_var_consts(t: int):
    """(t, one_shoup, 2^32 mod t, its shoup) as uint32 — the constants of
    modmath.mul_mod_var for the mod-t lane."""
    two32 = (1 << 32) % t
    return (np.uint32(t), np.uint32(mm.shoup_precompute(1, t)),
            np.uint32(two32), np.uint32(mm.shoup_precompute(two32, t)))


def _scale_product(a_scale, b_scale, t: int):
    """scale_t of a product ciphertext: host ints multiply on host; traced
    values multiply on device (no recompile per value)."""
    ha, hb = _host_scale(a_scale), _host_scale(b_scale)
    if ha is not None and hb is not None:
        return (ha * hb) % t
    tc = _t_var_consts(t)
    av = jnp.asarray(a_scale, jnp.uint32) if ha is None else np.uint32(ha % t)
    bv = jnp.asarray(b_scale, jnp.uint32) if hb is None else np.uint32(hb % t)
    return mm.mul_mod_var(av, bv, *tc)


def _fresh_noise_budget(ctx: SchemeContext):
    """Fresh budget from the variance model: BGV noise is t-scaled from
    birth, budget = log2(q/2) - log2(t * D*sqrt(V_fresh))."""
    return max(0.0, float(_noise.bgv_budget(
        ctx.params, 0, _noise.fresh_variance(ctx.params))))


# ---------------------------------------------------------------------------
# key generation
# ---------------------------------------------------------------------------


def keygen(ctx: SchemeContext, key: jax.Array) -> tuple[PublicKey, SecretKey]:
    """pk = (t*e - a*s, a) in NTT form, so pk0 + pk1*s = t*e."""
    p = ctx.params
    tb = ctx.ntt_q
    k_s, k_a, k_e = jax.random.split(key, 3)
    s = sampling.ternary_rns(k_s, tb.p, 1, p.n, p.security.hamming_weight)
    a = sampling.uniform_rns(k_a, tb.p, tb.mu, 1, p.n)
    e = sampling.gaussian_rns(k_e, tb.p, p.security.sigma, 1, p.n)
    s_ntt = _fwd_q(ctx, s)
    a_ntt = _fwd_q(ctx, a)
    te_ntt = _fwd_q(ctx, _t_scale(ctx, e))
    b_ntt = mm.sub_mod(te_ntt, _ntt.pointwise_mul(a_ntt, s_ntt, tb), _p3(tb))
    return PublicKey(data=jnp.concatenate([b_ntt, a_ntt], axis=1)), \
        SecretKey(data=s_ntt)


def _keyswitch_keygen(ctx: SchemeContext, key: jax.Array, sk: SecretKey,
                      target_ntt: jax.Array) -> jax.Array:
    """The shared RNS-digit gadget with BGV's t-scaled error (one
    implementation: bfv._keyswitch_keygen with t_scale_error=True)."""
    return _bfv._keyswitch_keygen(ctx, key, sk, target_ntt,
                                  t_scale_error=True)


def relinkey_gen(ctx: SchemeContext, key: jax.Array, sk: SecretKey) -> RelinKeys:
    tb = ctx.ntt_q
    s2 = _ntt.pointwise_mul(sk.data, sk.data, tb)
    return RelinKeys(data=_keyswitch_keygen(ctx, key, sk, s2))


def switch_relin_keys(ctx: SchemeContext, rlk: RelinKeys,
                      level: int) -> RelinKeys:
    """Precompute level-L BGV relinearization keys.  BGV keys MUST be
    switched with the t-corrected path (a plain BFV rounding switch would
    destroy the t*e error structure and silently corrupt decryptions) —
    always use this wrapper, never bfv.switch_relin_keys, for BGV keys."""
    return _bfv.switch_relin_keys(ctx, rlk, level, bgv=True)


def galoiskey_gen(ctx: SchemeContext, key: jax.Array, sk: SecretKey,
                  elements=None) -> GaloisKeys:
    tb = ctx.ntt_q
    elements = tuple(elements) if elements is not None else tuple(
        ctx.galois_src.keys())
    s_coeff = _inv_q(ctx, sk.data)
    out = {}
    for g in elements:
        key, sub = jax.random.split(key)
        s_g = _bfv._apply_galois_coeff(ctx, s_coeff, g)
        out[g] = _keyswitch_keygen(ctx, sub, sk, _fwd_q(ctx, s_g))
    return GaloisKeys(data=out)


# ---------------------------------------------------------------------------
# encrypt / decrypt
# ---------------------------------------------------------------------------


def encrypt(ctx: SchemeContext, key: jax.Array, pk: PublicKey,
            pt: Plaintext) -> Ciphertext:
    """ct = (pk0*u + t*e1 + m, pk1*u + t*e2), coefficient domain."""
    p = ctx.params
    tb = ctx.ntt_q
    k_u, k_e1, k_e2 = jax.random.split(key, 3)
    u = sampling.ternary_rns(k_u, tb.p, 1, p.n, p.security.hamming_weight)
    e1 = sampling.gaussian_rns(k_e1, tb.p, p.security.sigma, 1, p.n)
    e2 = sampling.gaussian_rns(k_e2, tb.p, p.security.sigma, 1, p.n)
    pk_u = _bfv._pk_u_product(ctx, u, pk)
    c0 = mm.add_mod(
        mm.add_mod(pk_u[:, :1], _t_scale(ctx, e1), _p3(tb)),
        _lift_plain(ctx, pt), _p3(tb))
    c1 = mm.add_mod(pk_u[:, 1:], _t_scale(ctx, e2), _p3(tb))
    return Ciphertext(
        data=jnp.concatenate([c0, c1], axis=1),
        level=0, is_ntt_form=False, scale_t=1,
        noise_budget=_fresh_noise_budget(ctx),
    )


def decrypt(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey) -> Plaintext:
    """m = [phase]_q mod t (exact centered reduction via sm_mrq with dst {t}),
    times the accumulated scale_t correction."""
    x = _phase(ctx, ct, sk)                              # [k, n]
    m = _rns.sm_mrq(x[:, None, :], ctx.bgv_dec_levels[ct.level])[0, 0]  # [n]
    t = ctx.params.t
    h = _host_scale(ct.scale_t)
    if h is None:
        # traced correction: generic variable multiply mod t on device
        m = mm.mul_mod_var(m, jnp.asarray(ct.scale_t, jnp.uint32),
                           *_t_var_consts(t))
    elif h % t != 1:
        s = h % t
        m = mm.mul_mod_shoup(m, np.uint32(s),
                             np.uint32(mm.shoup_precompute(s, t)),
                             np.uint32(t))
    return Plaintext(data=m)


# ---------------------------------------------------------------------------
# additive / plain ops
# ---------------------------------------------------------------------------


def _check_compat(a: Ciphertext, b: Ciphertext):
    """Level/domain check plus the BGV scale_t guard.

    CAVEAT: the scale_t guard runs only when both factors are concrete —
    which covers the eager path and the per-op jits of the FHE wrapper
    (their inputs are concrete outputs of the previous op).  Inside a
    whole-circuit user jit the factors are tracers and the guard is
    necessarily skipped (jax cannot branch on traced values); mixing
    differently-scaled operands there silently mis-adds plaintexts — keep
    operand scales aligned via mod_switch_to_level, as every supported
    workflow does (tests/test_bgv_scheme.py::test_add_rejects_scale_mismatch
    pins the eager guard)."""
    _bfv._check_compat(a, b)
    ha, hb = _host_scale(a.scale_t), _host_scale(b.scale_t)
    if ha is not None and hb is not None and ha != hb:
        raise ValueError(
            f"BGV scale_t mismatch ({ha} vs {hb}): "
            "mod-switch both operands to the same level first")


def add(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_compat(a, b)
    return _bfv.add(ctx, a, b)


def sub(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_compat(a, b)
    return _bfv.sub(ctx, a, b)


def _pt_for_scale(ctx: SchemeContext, pt: Plaintext, scale_t) -> Plaintext:
    """The ciphertext's raw plaintext is m*scale_t^-1; a plain operand must be
    pre-divided by scale_t so the sum decrypts to m_ct + m_pt."""
    t = ctx.params.t
    h = _host_scale(scale_t)
    if h is not None:
        if h % t == 1:
            return pt
        inv = pow(h, -1, t)
        return pt.replace(data=mm.mul_mod_shoup(
            pt.data, np.uint32(inv), np.uint32(mm.shoup_precompute(inv, t)),
            np.uint32(t)))
    # traced: Fermat inverse scale_t^(t-2) mod prime t, then a variable mul
    tc = _t_var_consts(t)
    inv = mm.pow_mod_var(jnp.asarray(scale_t, jnp.uint32), t - 2, *tc)
    return pt.replace(data=mm.mul_mod_var(pt.data, inv, *tc))


def add_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    """c0 += m (no Delta scaling — BGV plaintext sits in the LSB); any level.
    NTT-form ciphertexts stay resident (the operand is transformed instead,
    one [k, 1, n] NTT — see bfv.add_plain)."""
    pt = _pt_for_scale(ctx, pt, ct.scale_t)
    tb = _tb(ctx, ct.level)
    op = _lift_plain(ctx, pt, ct.level)
    if ct.is_ntt_form:
        op = _fwd_q(ctx, op, ct.level)
    c0 = _poly.add(ct.data[:, :1], op, tb)
    return ct.replace(data=jnp.concatenate([c0, ct.data[:, 1:]], axis=1))


def sub_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    pt = _pt_for_scale(ctx, pt, ct.scale_t)
    tb = _tb(ctx, ct.level)
    op = _lift_plain(ctx, pt, ct.level)
    if ct.is_ntt_form:
        op = _fwd_q(ctx, op, ct.level)
    c0 = _poly.sub(ct.data[:, :1], op, tb)
    return ct.replace(data=jnp.concatenate([c0, ct.data[:, 1:]], axis=1))


def multiply_plain(ctx: SchemeContext, ct: Ciphertext, pt: Plaintext,
                   pt_ntt: jax.Array | None = None) -> Ciphertext:
    """c_i *= m — identical arithmetic to BFV's (phase scales by m either way).
    scale_t is multiplicative, so no operand correction is needed (the
    decoder divides the ciphertext's own scale back out)."""
    return _bfv.multiply_plain(ctx, ct, pt, pt_ntt)


# ---------------------------------------------------------------------------
# multiply + relinearize
# ---------------------------------------------------------------------------


def multiply_no_relin(ctx: SchemeContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """Plain tensor product mod q — no rescaling (BGV's defining contrast to
    BFV's BEHZ pipeline).  Noise multiplies; manage with mod_switch_to_next."""
    if a.level != b.level:
        raise ValueError("ciphertext level mismatch")
    ha, hb = _host_scale(a.scale_t), _host_scale(b.scale_t)
    if ha is not None and hb is not None and ha != hb:
        raise ValueError("BGV scale_t mismatch")
    if a.num_components != 2 or b.num_components != 2:
        raise ValueError(
            "multiply needs 2-component ciphertexts; relinearize first "
            f"(got {a.num_components} and {b.num_components})")
    level = a.level
    tb = _tb(ctx, level)
    if a.is_ntt_form and b.is_ntt_form:
        # operands already in evaluation form: skip the forward transforms
        p = _p3(tb)
        af, bf = a.data, b.data
        c0 = _ntt.pointwise_mul(af[:, :1], bf[:, :1], tb)
        c2 = _ntt.pointwise_mul(af[:, 1:], bf[:, 1:], tb)
        c1 = mm.add_mod(
            _ntt.pointwise_mul(af[:, :1], bf[:, 1:], tb),
            _ntt.pointwise_mul(af[:, 1:], bf[:, :1], tb), p)
        data = _inv_q(ctx, jnp.concatenate([c0, c1, c2], axis=1), level)
    else:
        a = to_coeff(ctx, a)
        b = to_coeff(ctx, b)
        data = _bfv._dispatch_tensor_product(ctx, a.data, b.data, level)
    v = _noise.bgv_multiply(
        ctx.params,
        _noise.bgv_variance(ctx.params, level, a.noise_budget),
        _noise.bgv_variance(ctx.params, level, b.noise_budget))
    return Ciphertext(
        data=data, level=level, is_ntt_form=False,
        scale_t=_scale_product(a.scale_t, b.scale_t, ctx.params.t),
        noise_budget=jnp.maximum(
            0.0, _noise.bgv_budget(ctx.params, level, v)),
    )


def relinearize(ctx: SchemeContext, ct: Ciphertext, rlk: RelinKeys,
                keys_at_level: bool = False) -> Ciphertext:
    """Identical inner-product key switch to BFV (keys carry t-scaled error,
    so the added term is ≡ 0 mod t as BGV requires); level-0 keys are
    t-corrected-switched down for deeper ciphertexts."""
    return _bfv.relinearize(ctx, ct, rlk, bgv=True,
                            keys_at_level=keys_at_level)


def multiply(ctx: SchemeContext, a: Ciphertext, b: Ciphertext,
             rlk: RelinKeys, keys_at_level: bool = False) -> Ciphertext:
    return relinearize(ctx, multiply_no_relin(ctx, a, b), rlk,
                       keys_at_level=keys_at_level)


def multiply_batch(ctx: SchemeContext, cts_a: list, cts_b: list,
                   rlk: RelinKeys, keys_at_level: bool = False) -> list:
    """B independent BGV multiply+relinearize ops; element i is bit-exact
    with multiply(ctx, cts_a[i], cts_b[i], rlk)."""
    if len(cts_a) != len(cts_b) or not cts_a:
        raise ValueError("multiply_batch needs equal-length non-empty lists")
    return [multiply(ctx, a, b, rlk, keys_at_level)
            for a, b in zip(cts_a, cts_b)]


# ---------------------------------------------------------------------------
# rotations (scheme-agnostic given BGV Galois keys)
# ---------------------------------------------------------------------------


def rotate_rows(ctx: SchemeContext, ct: Ciphertext, steps: int,
                gal_keys: GaloisKeys, keys_at_level: bool = False) -> Ciphertext:
    return _bfv.rotate_rows(ctx, ct, steps, gal_keys, bgv=True,
                            keys_at_level=keys_at_level)


def rotate_columns(ctx: SchemeContext, ct: Ciphertext,
                   gal_keys: GaloisKeys, keys_at_level: bool = False) -> Ciphertext:
    return _bfv.rotate_columns(ctx, ct, gal_keys, bgv=True,
                               keys_at_level=keys_at_level)


def switch_galois_keys(ctx: SchemeContext, gal_keys: GaloisKeys,
                       level: int) -> GaloisKeys:
    """t-corrected per-level Galois keys (see bgv.switch_relin_keys)."""
    return _bfv.switch_galois_keys(ctx, gal_keys, level, bgv=True)


# ---------------------------------------------------------------------------
# modulus switching / bootstrap / noise
# ---------------------------------------------------------------------------


def mod_switch_to_next(ctx: SchemeContext, ct: Ciphertext) -> Ciphertext:
    """Drop the last prime with the mod-t correction; this is BGV's primary
    noise-management tool (divides noise by ~q_last)."""
    ct = to_coeff(ctx, ct)
    if ct.level >= ctx.k - 1:
        raise ValueError("already at the last level")
    mc = ctx.bgv_mod_switch[ct.level]
    new = _rns.bgv_mod_switch_drop_last(ct.data, mc)
    q_last = int(ctx.params.q_primes[ctx.k - 1 - ct.level])
    # noise divides by q_last but q also shrinks by q_last: budget roughly
    # preserved minus the rounding term (variance model)
    v = _noise.bgv_mod_switch(
        ctx.params, ct.level,
        _noise.bgv_variance(ctx.params, ct.level, ct.noise_budget))
    return ct.replace(
        data=new, level=ct.level + 1,
        scale_t=_scale_product(ct.scale_t, q_last, ctx.params.t),
        noise_budget=jnp.maximum(
            0.0, _noise.bgv_budget(ctx.params, ct.level + 1, v)))


def mod_switch_to_level(ctx: SchemeContext, ct: Ciphertext, target: int) -> Ciphertext:
    while ct.level < target:
        ct = mod_switch_to_next(ctx, ct)
    return ct


def bootstrap(ctx: SchemeContext, key: jax.Array, ct: Ciphertext,
              sk: SecretKey, pk: PublicKey) -> Ciphertext:
    """Recrypt-style refresh (the reference's declared sk-taking contract)."""
    pt = decrypt(ctx, ct, sk)
    return encrypt(ctx, key, pk, pt)


def estimate_noise_budget(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey) -> float:
    """log2(q/2) - log2(||phase - m||_inf), host-side CRT diagnostic."""
    p = ctx.params
    primes_l = p.q_primes[: ctx.k - ct.level]
    q = math.prod(primes_l)
    x = np.asarray(_phase(ctx, ct, sk))
    m_scaled = np.asarray(decrypt(ctx, ct, sk).data)      # true m
    s = _host_scale(ct.scale_t)
    inv_scale = pow(s, -1, p.t) if s != 1 else 1
    coeffs = _rns.from_rns_host(x, primes_l)
    worst = 1
    for j, c in enumerate(coeffs):
        m_raw = int(m_scaled[j]) * inv_scale % p.t       # m as the phase holds it
        v = (c - m_raw) % q
        if v > q // 2:
            v = q - v
        worst = max(worst, v)
    return max(0.0, math.log2(q / 2.0) - math.log2(worst))


def exact_noise_budget(ctx: SchemeContext, ct: Ciphertext, sk: SecretKey,
                       pt: Plaintext) -> float:
    """Noise budget measured against a KNOWN expected plaintext (see
    bfv.exact_noise_budget: goes negative past exhaustion instead of
    re-centering on a wrong decryption).  pt holds the expected decode-side
    plaintext mod t; the phase holds m * scale_t^-1.

    Same aliasing caveat as bfv.exact_noise_budget: readings under ~1 bit
    may be a wrapped (> q/2) noise masquerading as small-positive — treat
    them as exhaustion, cross-checked against the tracked budget."""
    p = ctx.params
    primes_l = p.q_primes[: ctx.k - ct.level]
    q = math.prod(primes_l)
    x = np.asarray(_phase(ctx, ct, sk))
    s = _host_scale(ct.scale_t)
    inv_scale = pow(s, -1, p.t) if s != 1 else 1
    coeffs = _rns.from_rns_host(x, primes_l)
    m = np.asarray(pt.data)
    worst = 1
    for j, c in enumerate(coeffs):
        m_raw = int(m[j]) * inv_scale % p.t
        v = (c - m_raw) % q
        if v > q // 2:
            v = q - v
        worst = max(worst, v)
    return math.log2(q / 2.0) - math.log2(worst)
