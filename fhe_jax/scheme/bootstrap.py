"""Bootstrapping helpers: extract_lsb + blind_rotate (+ the composed refresh).

Implements the reference's declared bootstrapping pipeline
(``include/fhe.cuh:138-140``; README "Bootstrapping Implementation":
extract LSB -> blind rotation -> modulus raise -> key switching) with real
math, in jittable JAX:

  * ``extract_lsb``  — moves the plaintext bit to the q/2 ("sign") position,
    switches the whole RLWE pair to the small modulus 2n with the exact
    gamma-trick rounding (ops/rns.decrypt_scale at t = 2n), and
    sample-extracts one coefficient as an LWE ciphertext over Z_{2n}.
  * ``blind_rotate`` — CGGI/TFHE-style accumulator rotation: a trivial RLWE
    encryption of the test vector is multiplied by X^{-phase} one encrypted
    digit at a time, via RGSW external products driven by CMUX gates.  The
    ternary secret is split s = s+ - s- into two binary vectors, each with
    its own RGSW key set.  The gadget is the library's RNS-digit gadget
    (the same decomposition as relinearization), so an external product is
    exactly a double-width key-switch inner product.
  * ``modulus_raise`` / ``key_switch`` — the existing scheme ops complete
    the declared pipeline.

The RGSW bootstrap keys are generated FROM the secret key, matching the
reference's declared ``blind_rotate(result, ct, sk)`` contract (a trusted
helper, like its sk-taking ``bootstrap``); they encrypt the key's own bits
under itself (standard circular-security assumption).

Documented limits:
  * Binary message space: ``bootstrap_binary`` refreshes a ciphertext whose
    plaintext constant coefficient is a bit (general lookup tables work via
    the ``test_poly`` argument of blind_rotate — programmable bootstrap).
  * Correctness needs the input noise below q/(2t) (i.e. the ciphertext
    still decryptable) and the rounding noise below n/2 at modulus 2n:
    h/2 + (2n/q) * ||e|| * t/2 < n/2, satisfied for all supported params.
  * Cost is 2n external products; use small n / leveled inputs.  This is a
    latency-oriented correctness path, not the headline throughput path.

Oracle-checked end to end in tests/test_bootstrap.py.
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
from ..utils import struct
from . import bfv as _bfv
from . import noise as _noise
from .context import SchemeContext
from .types import Ciphertext, SecretKey

_U = np.uint32


@struct.dataclass
class LWECiphertext:
    """LWE sample over Z_{2n}: phase = b + <a, s> = (2n/2)*bit + e (mod 2n).

    The reference's "RLWE' (different ring)" intermediate (README pipeline
    step 1): after extract_lsb the ciphertext lives over plain integers mod
    2n, one scalar b and one length-n mask a."""

    a: jax.Array   # [n] uint32 in [0, 2n)
    b: jax.Array   # []  uint32 in [0, 2n)


@struct.dataclass
class BootstrapKey:
    """RGSW encryptions of the secret key bits, RNS-digit gadget.

    For each coefficient j of the ternary secret (s = s+ - s-), and each of
    the 2*kl gadget rows (kl digits for acc0, kl for acc1), an RLWE pair in
    NTT form.  Shapes: [n, 2*kl, kl, 2, n_ring]."""

    pos: jax.Array
    neg: jax.Array
    level: int = struct.field(pytree_node=False)


# ---------------------------------------------------------------------------
# extract_lsb
# ---------------------------------------------------------------------------


def _small_mod_consts(ctx: SchemeContext, level: int) -> _rns.DecryptConsts:
    """decrypt_scale constants for rounding q_level -> 2n (exact rounded
    division, the same gamma-trick machinery as decryption)."""
    primes_l = ctx.params.q_primes[: ctx.k - level]
    host = _rns._decrypt_host(tuple(int(p) for p in primes_l),
                              2 * ctx.params.n, int(ctx.params.gamma))
    return _rns.DecryptConsts(**{f: jnp.asarray(v) for f, v in host.items()})


def extract_lsb(ctx: SchemeContext, ct: Ciphertext, index: int = 0
                ) -> LWECiphertext:
    """RLWE -> LWE over Z_{2n}: the declared LSB-extraction step
    (``include/fhe.cuh:138``); the payload_bits=1 case of
    extract_payload below."""
    return extract_payload(ctx, ct, 1, index)


def extract_payload(ctx: SchemeContext, ct: Ciphertext,
                    payload_bits: int = 1, index: int = 0
                    ) -> LWECiphertext:
    """RLWE -> LWE over Z_{2n} carrying a w-bit payload in the top bits.

    1. scalar-multiply by floor(t/2^w): plaintext m in [0, 2^w) moves from
       the Delta position to the top — phase ~ (q/2^w)*m + (t/2^w)*e,
    2. exact-round every component to the small modulus 2n: phase over
       Z_2n ~ m * (2n/2^w),
    3. sample-extract coefficient ``index``:
         b = c0'[index],   a_j carrying <a, s_coeffs> via the negacyclic
         index algebra (a_j = c1'[index-j], negated for wrapped indices).

    w = 1 is the binary pipeline; larger w feeds bootstrap_lut (the
    programmable bootstrap), whose LUT domain is [0, 2^(w-1)) — the top
    bit is the negacyclic padding bit.
    """
    p = ctx.params
    n = p.n
    ct = _bfv.to_coeff(ctx, ct)
    assert ct.num_components == 2, "extract needs a 2-component ct"
    level = ct.level
    tb = _bfv._tb(ctx, level)

    half_t = p.t >> payload_bits
    assert half_t > 0, "payload wider than the plaintext modulus"
    scaled = _poly.mul_scalar(ct.data, half_t, tb)      # [kl, 2, n]

    dc = _small_mod_consts(ctx, level)
    small = _rns.decrypt_scale(scaled, dc)              # [2, n] mod 2n

    c0s, c1s = small[0], small[1]
    two_n = np.uint32(2 * n)
    b = c0s[index]
    # phase_index = c0[index] + sum_j c1[j] * (s poly) coefficient algebra:
    # (c1 * s)[index] = sum_{j<=index} c1[j] s[index-j] - sum_{j>index} c1[j] s[n+index-j]
    # so the LWE mask over s coefficients s_i is a_i = c1[index-i] for
    # i <= index, and a_i = -c1[n+index-i] for i > index.
    i = np.arange(n)
    src = (index - i) % n
    wrap = i > index
    a = jnp.take(c1s, jnp.asarray(src))
    a = jnp.where(jnp.asarray(wrap), (two_n - a) % two_n, a)
    return LWECiphertext(a=a.astype(jnp.uint32), b=b.astype(jnp.uint32))


# ---------------------------------------------------------------------------
# RGSW bootstrap keys
# ---------------------------------------------------------------------------


def make_bootstrap_key(ctx: SchemeContext, key: jax.Array, sk: SecretKey,
                       level: int = 0) -> BootstrapKey:
    """RGSW(s+_j), RGSW(s-_j) for every secret coefficient j, at ``level``.

    Row layout (per j): rows d < kl multiply acc0's digit d and encrypt
    bit * W_d; rows kl + d multiply acc1's digit d and encrypt
    bit * W_d * s — together an external product reconstructs
    bit * (acc0 + acc1 * s) plus gadget noise (see _external_product)."""
    p = ctx.params
    n = p.n
    kl = ctx.k - level
    tb = _bfv._tb(ctx, level)
    primes_l = p.q_primes[:kl]
    q_l = math.prod(int(x) for x in primes_l)
    # gadget factors W_d mod every prime: [kl_digits, kl_primes]
    w = np.zeros((kl, kl), dtype=_U)
    for d, pd in enumerate(primes_l):
        for i, pi in enumerate(primes_l):
            w[d, i] = (q_l // pd) % pi
    w = jnp.asarray(w)

    sk_l = sk.data[:kl]
    s_coeff = _bfv._inv_q(ctx, sk_l, level)[:, 0]       # [kl, n] residues
    # ternary bits from the first prime's residues: 1 -> s+=1; p-1 -> s-=1
    row0 = s_coeff[0]
    p0 = tb.p[0]
    pos_bits = (row0 == jnp.uint32(1)).astype(jnp.uint32)       # [n]
    neg_bits = (row0 == p0 - jnp.uint32(1)).astype(jnp.uint32)  # [n]

    # batched RLWE(0) rows: one uniform a and error e per (j, sign, row)
    rows_per_j = 2 * kl
    total = n * 2 * rows_per_j
    k_a, k_e = jax.random.split(key)
    a = sampling.uniform_rns(k_a, tb.p, tb.mu, total, n)
    e = sampling.gaussian_rns(k_e, tb.p, p.security.sigma, total, n)
    a_ntt = _bfv._fwd_q(ctx, a, level)
    e_ntt = _bfv._fwd_q(ctx, e, level)
    b_ntt = mm.sub_mod(e_ntt, _ntt.pointwise_mul(
        a_ntt, jnp.broadcast_to(sk_l, (kl, total, n)), tb),
        tb.p[:, None, None])
    # [kl_primes, n, 2(sign), 2kl(rows), n_ring]
    b_ntt = b_ntt.reshape(kl, n, 2, rows_per_j, n)
    a_ntt = a_ntt.reshape(kl, n, 2, rows_per_j, n)

    # message terms: bit * W_d (rows d < kl) and bit * W_d * s (rows >= kl),
    # all in NTT form (a constant c transforms to the all-c vector).
    s_ntt_poly = sk_l[:, 0]                              # [kl, n] NTT of s
    ones = jnp.ones((kl, n), jnp.uint32)
    targets = []
    for d in range(kl):
        targets.append(mm.mul_mod_shoup(
            ones, w[d][:, None],
            jnp.asarray([mm.shoup_precompute(int(w[d, i]), int(primes_l[i]))
                         for i in range(kl)], dtype=jnp.uint32)[:, None],
            tb.p[:, None]))
    for d in range(kl):
        targets.append(mm.mul_mod_barrett(
            s_ntt_poly, targets[d], tb.p[:, None], tb.mu[:, None]))
    tgt = jnp.stack(targets, axis=1)                     # [kl, 2kl, n_ring]

    def add_msg(bits, sign_idx):
        # bits [n] -> b_ntt + bit_j * tgt on the matching rows
        msg = tgt[:, None, :, :] * bits[None, :, None, None]  # 0/1 gate
        return mm.add_mod(b_ntt[:, :, sign_idx],
                          msg.astype(jnp.uint32), tb.p[:, None, None, None])

    b_pos = add_msg(pos_bits, 0)
    b_neg = add_msg(neg_bits, 1)
    # assemble [n, 2kl, kl, 2, n_ring]
    def pack(bn, an):
        bt = jnp.transpose(bn, (1, 2, 0, 3))             # [n, 2kl, kl, n]
        at = jnp.transpose(an, (1, 2, 0, 3))
        return jnp.stack([bt, at], axis=3)               # [n, 2kl, kl, 2, n]

    return BootstrapKey(
        pos=pack(b_pos, a_ntt[:, :, 0]),
        neg=pack(b_neg, a_ntt[:, :, 1]),
        level=level,
    )


# ---------------------------------------------------------------------------
# external product / CMUX / blind rotation
# ---------------------------------------------------------------------------


def _digits(ctx: SchemeContext, poly: jax.Array, level: int) -> jax.Array:
    """[kl, n] coeff poly -> [kl_primes, kl_digits, n] gadget digits
    (identical decomposition to bfv._keyswitch_inner)."""
    tb = _bfv._tb(ctx, level)
    inv_qhat, inv_qhat_sh = ctx.inv_qhat_levels[level]
    d = mm.mul_mod_shoup(poly, inv_qhat[:, None], inv_qhat_sh[:, None],
                         tb.p[:, None])
    return mm.barrett_reduce_u32(
        d[None, :, :], tb.p[:, None, None], tb.mu[:, None, None])


def _external_product(ctx: SchemeContext, acc: jax.Array, rows: jax.Array,
                      level: int) -> jax.Array:
    """acc (x) RGSW: [kl, 2, n] coeff x [2kl, kl, 2, n] NTT -> [kl, 2, n].

    Decomposes both acc components into RNS digits, multiplies each digit
    by its RGSW row and tree-sums — a double-width key-switch inner product.
    """
    tb = _bfv._tb(ctx, level)
    d0 = _digits(ctx, acc[:, 0], level)
    d1 = _digits(ctx, acc[:, 1], level)
    d = jnp.concatenate([d0, d1], axis=1)                # [kl, 2kl, n]
    d_ntt = _bfv._fwd_q(ctx, d, level)
    kt = jnp.transpose(rows, (1, 0, 2, 3))               # [kl, 2kl, 2, n]
    p4 = tb.p[:, None, None, None]
    prod = mm.mul_mod_barrett(d_ntt[:, :, None, :], kt, p4,
                              tb.mu[:, None, None, None])
    acc_ntt = mm.add_mod_tree(prod, p4, axis=1)[:, 0]    # [kl, 2, n]
    return _bfv._inv_q(ctx, acc_ntt, level)


def _monomial_mul(x: jax.Array, r, n: int, p) -> jax.Array:
    """x * X^r in Z_p[X]/(X^n+1), r a traced integer in [0, 2n)."""
    j = jnp.arange(n, dtype=jnp.int32)
    e = jnp.mod(j - r.astype(jnp.int32), 2 * n)
    idx = jnp.where(e < n, e, e - n)
    flip = e >= n
    g = jnp.take(x, idx, axis=-1)
    return jnp.where(flip[None, None, :], mm.neg_mod(g, p), g)


def _monomial_mul_bits(x: jax.Array, r, n: int, p) -> jax.Array:
    """x * X^r with PER-SAMPLE traced shifts, gather-free.

    x [..., B, C, n], r [B] in [0, 2n).  X^r = prod_i X^{2^i * bit_i(r)}:
    1 + log2(n) conditional STATIC negacyclic rolls + one conditional
    negation (the X^n = -1 bit) — every op full-width across the batch,
    no per-batch-index take_along_axis.  Bit-exact with _monomial_mul per
    sample."""
    r = r.astype(jnp.uint32)
    out = x
    gate = r[:, None, None]
    j = jnp.arange(n, dtype=jnp.int32)
    for i in range(n.bit_length() - 1):                  # 2^i < n
        c = 1 << i
        rolled = jnp.roll(out, c, axis=-1)
        rolled = jnp.where(j < c, mm.neg_mod(rolled, p), rolled)
        bit = (gate >> i) & jnp.uint32(1)
        out = jnp.where(bit == 1, rolled, out)
    # the 2^log2(n) bit: X^n = -1
    bit = (gate >> (n.bit_length() - 1)) & jnp.uint32(1)
    return jnp.where(bit == 1, mm.neg_mod(out, p), out)


def _external_product_batch(ctx: SchemeContext, acc: jax.Array,
                            rows: jax.Array, level: int) -> jax.Array:
    """B accumulators (x) ONE shared RGSW: [kl, B, 2, n] x [2kl, kl, 2, n]
    NTT -> [kl, B, 2, n].  The digit rows of all B samples ride one forward
    transform (batch axis 2kl*B), and the inner products run over all B
    accumulators at once."""
    tb = _bfv._tb(ctx, level)
    kl, B, _, n = acc.shape
    inv_qhat, inv_qhat_sh = ctx.inv_qhat_levels[level]
    # digits of both components: [kl_primes, B, 2kl_digits, n]
    d = mm.mul_mod_shoup(
        jnp.transpose(acc, (1, 2, 0, 3)),                # [B, 2, kl, n]
        inv_qhat[:, None], inv_qhat_sh[:, None], tb.p[:, None])
    # broadcast every digit to every prime row and reduce (same pattern as
    # the single-sample _digits, batch folded into the row axis)
    d = mm.barrett_reduce_u32(
        d.reshape(1, B * 2 * kl, n), tb.p[:, None, None],
        tb.mu[:, None, None])                            # [kl, B*2kl, n]
    d_ntt = _bfv._fwd_q(ctx, d, level)                   # [kl, B*2kl, n]
    d_ntt = d_ntt.reshape(kl, B, 2 * kl, n)
    kt = jnp.transpose(rows, (1, 0, 2, 3))               # [kl, 2kl, 2, n]
    p5 = tb.p[:, None, None, None, None]
    prod = mm.mul_mod_barrett(
        d_ntt[:, :, :, None, :], kt[:, None], p5,
        tb.mu[:, None, None, None, None])                # [kl, B, 2kl, 2, n]
    acc_ntt = mm.add_mod_tree(prod, p5, axis=2)[:, :, 0]  # [kl, B, 2, n]
    return _bfv._inv_q(
        ctx, acc_ntt.reshape(kl, B * 2, n), level).reshape(kl, B, 2, n)


def blind_rotate_batch(ctx: SchemeContext, a_batch: jax.Array,
                       b_batch: jax.Array, bsk: BootstrapKey,
                       test_poly: jax.Array | None = None) -> jax.Array:
    """B independent accumulator rotations sharing one bootstrap key.

    a_batch [B, n], b_batch [B] (stacked LWECiphertexts).  Returns the raw
    accumulator stack [kl, B, 2, n]; sample i equals blind_rotate on
    LWECiphertext(a_batch[i], b_batch[i]) up to the (identical) CMUX math —
    the per-step monomial rotations run gather-free (_monomial_mul_bits)
    and both external products amortize over the batch."""
    p = ctx.params
    n = p.n
    level = bsk.level
    tb = _bfv._tb(ctx, level)
    p4 = tb.p[:, None, None, None]
    B = a_batch.shape[0]

    if test_poly is None:
        test_poly = _sign_test_poly(ctx, level)

    shift0 = jnp.mod(jnp.int32(n // 2) - b_batch.astype(jnp.int32),
                     jnp.int32(2 * n)).astype(jnp.uint32)
    tv = jnp.broadcast_to(test_poly[:, None], (ctx.k - level, B, 1, n))
    acc0 = _monomial_mul_bits(tv, shift0, n, p4)
    acc = jnp.concatenate([acc0, jnp.zeros_like(acc0)], axis=2)

    def step(acc, inputs):
        a_j, rows_pos, rows_neg = inputs                 # a_j [B]
        neg_aj = jnp.mod(jnp.int32(2 * n) - a_j.astype(jnp.int32),
                         jnp.int32(2 * n)).astype(jnp.uint32)
        rot = _monomial_mul_bits(acc, neg_aj, n, p4)
        diff = mm.sub_mod(rot, acc, p4)
        acc = mm.add_mod(
            acc, _external_product_batch(ctx, diff, rows_pos, level), p4)
        rot2 = _monomial_mul_bits(acc, a_j, n, p4)
        diff2 = mm.sub_mod(rot2, acc, p4)
        acc = mm.add_mod(
            acc, _external_product_batch(ctx, diff2, rows_neg, level), p4)
        return acc, None

    acc, _ = jax.lax.scan(step, acc, (a_batch.T, bsk.pos, bsk.neg))
    return acc


def bootstrap_binary_batch(ctx: SchemeContext, cts: list,
                           bsk: BootstrapKey, ks_keys: jax.Array) -> list:
    """B independent binary bootstraps through ONE batched blind rotation
    (the 2n external products are the serial cost; batching B accumulators
    through them amortizes the gadget NTTs and inner products).  Element i's plaintext equals
    bootstrap_binary(cts[i])'s."""
    p = ctx.params
    level = cts[0].level
    assert all(ct.level == level for ct in cts)
    if bsk.level != level:
        raise ValueError(
            f"bootstrap key level {bsk.level} != ciphertext level {level}")
    lwes = [extract_lsb(ctx, ct, index=0) for ct in cts]
    a_batch = jnp.stack([l.a for l in lwes])
    b_batch = jnp.stack([l.b for l in lwes])
    acc = blind_rotate_batch(ctx, a_batch, b_batch, bsk)

    kl = ctx.k - level
    primes_l = p.q_primes[:kl]
    q_l = math.prod(int(x) for x in primes_l)
    c = (q_l // p.t) // 2
    tb = _bfv._tb(ctx, level)
    cvec = jnp.asarray(np.array([c % int(pi) for pi in primes_l], dtype=_U))
    lv = math.log2(4 * p.n) + _noise.keyswitch_add(p, level)
    outs = []
    for i, ct in enumerate(cts):
        data = acc[:, i]
        c0 = data[:, 0].at[:, 0].set(mm.add_mod(data[:, 0, 0], cvec, tb.p))
        out = Ciphertext(
            data=jnp.concatenate([c0[:, None, :], data[:, 1:]], axis=1),
            level=level, is_ntt_form=False,
            noise_budget=max(0.0, float(_noise.bfv_budget(p, level, lv))))
        if level:
            lv_rot = _noise.bfv_variance(p, level, out.noise_budget)
            out = _bfv.modulus_raise(ctx, out)
            q_drop = math.prod(int(x) for x in p.q_primes[kl:])
            drop_res = jnp.asarray(np.array(
                [q_drop % int(pi) for pi in p.q_primes], dtype=_U))
            out = out.replace(
                data=_poly.mul_scalar(out.data, drop_res, ctx.ntt_q),
                noise_budget=jnp.maximum(0.0, _noise.bfv_budget(
                    p, 0, 2.0 * math.log2(q_drop) + lv_rot)))
        out = _bfv.key_switch(ctx, out, ks_keys)
        outs.append(out.replace(noise_budget=jnp.maximum(
            0.0, _noise.bfv_budget(
                p, 0, _noise.add(
                    _noise.bfv_variance(p, 0, out.noise_budget),
                    _noise.keyswitch_add(p, 0))))))
    return outs


def blind_rotate(ctx: SchemeContext, lwe: LWECiphertext,
                 bsk: BootstrapKey | None = None, *,
                 sk: SecretKey | None = None, key: jax.Array | None = None,
                 test_poly: jax.Array | None = None,
                 offset: int | None = None,
                 level: int = 0) -> Ciphertext:
    """Accumulator blind rotation (``include/fhe.cuh:139``): returns an RLWE
    encryption of X^{-phase(lwe)} * test_poly under the scheme key.

    Matches the reference's declared sk-taking contract: pass ``sk`` (and a
    PRNG ``key``) to derive the RGSW bootstrap key on the fly, or pass a
    precomputed ``bsk`` (make_bootstrap_key) for repeated use.

    test_poly: [kl, 1, n] residues; defaults to the sign test vector
    floor(Delta/2) * (1 + X + ... + X^{n-1}) used by bootstrap_binary.
    """
    p = ctx.params
    n = p.n
    if bsk is None:
        if sk is None or key is None:
            raise ValueError("blind_rotate needs bsk, or sk + key")
        bsk = make_bootstrap_key(ctx, key, sk, level)
    elif bsk.level != level:
        raise ValueError(
            f"bootstrap key was generated at level {bsk.level} but the "
            f"rotation was requested at level {level}; regenerate with "
            f"make_bootstrap_key(..., level={level})")
    level = bsk.level
    kl = ctx.k - level
    tb = _bfv._tb(ctx, level)
    p3 = tb.p[:, None, None]

    if test_poly is None:
        test_poly = _sign_test_poly(ctx, level)

    # acc = (X^{offset - b} * testv, 0): the half-plateau offset centers
    # each plateau so |rounding noise| < plateau/2 flips nothing
    # (binary: offset = n/2; bootstrap_lut passes its plateau half S/2).
    off = n // 2 if offset is None else int(offset)
    shift0 = jnp.mod(jnp.int32(off) - lwe.b.astype(jnp.int32),
                     jnp.int32(2 * n)).astype(jnp.uint32)
    acc0 = _monomial_mul(test_poly, shift0, n, p3)
    acc = jnp.concatenate([acc0, jnp.zeros_like(acc0)], axis=1)  # [kl, 2, n]

    def step(acc, inputs):
        a_j, rows_pos, rows_neg = inputs
        # CMUX with s+: acc += (X^{-a_j} acc - acc) (x) RGSW(s+_j)
        rot = _monomial_mul(acc, jnp.mod(jnp.int32(2 * n) - a_j.astype(
            jnp.int32), jnp.int32(2 * n)).astype(jnp.uint32), n, p3)
        diff = mm.sub_mod(rot, acc, p3)
        acc = mm.add_mod(acc, _external_product(ctx, diff, rows_pos, level),
                         p3)
        # CMUX with s-: acc += (X^{+a_j} acc - acc) (x) RGSW(s-_j)
        rot2 = _monomial_mul(acc, a_j, n, p3)
        diff2 = mm.sub_mod(rot2, acc, p3)
        acc = mm.add_mod(acc, _external_product(ctx, diff2, rows_neg, level),
                         p3)
        return acc, None

    acc, _ = jax.lax.scan(step, acc, (lwe.a, bsk.pos, bsk.neg))

    lv = math.log2(4 * n) + _noise.keyswitch_add(p, level)
    return Ciphertext(
        data=acc, level=level, is_ntt_form=False,
        noise_budget=max(0.0, float(_noise.bfv_budget(p, level, lv))),
    )


def _sign_test_poly(ctx: SchemeContext, level: int) -> jax.Array:
    """floor(Delta_level/2) * (1 + X + ... + X^{n-1}) as [kl, 1, n] residues."""
    p = ctx.params
    kl = ctx.k - level
    primes_l = p.q_primes[:kl]
    q_l = math.prod(int(x) for x in primes_l)
    c = (q_l // p.t) // 2
    vals = np.stack([np.full(p.n, c % int(pi), dtype=_U) for pi in primes_l])
    return jnp.asarray(vals)[:, None, :]


def _lut_test_poly(ctx: SchemeContext, level: int, lut,
                   payload_bits: int) -> jax.Array:
    """Plateau test polynomial for the programmable bootstrap.

    With offset S/2 (S = 2n / 2^w), the rotated accumulator's coefficient
    0 reads G(phase - S/2) where G is the negacyclic extension of the
    coefficient vector (G(e) = T[e] on [0, n), -T[e-n] on [n, 2n)).  A
    payload m has phase ~ m*S, so e lands in (mS - S, mS):

        T[(m-1)S : mS] = Delta * lut[m]      for m = 1 .. 2^(w-1)-1
        T[n-S : n]     = -Delta * lut[0]     (m = 0 wraps negacyclically)

    The top half of the payload space (m >= 2^(w-1)) is the padding bit —
    callers keep plaintexts below it (any negacyclic-antisymmetric f could
    use the full range, but an arbitrary LUT cannot)."""
    p = ctx.params
    n = p.n
    w = payload_bits
    S = (2 * n) >> w
    assert S >= 2, "payload too wide for the ring degree"
    m_max = 1 << (w - 1)
    assert len(lut) == m_max, (len(lut), m_max)
    kl = ctx.k - level
    primes_l = p.q_primes[:kl]
    q_l = math.prod(int(x) for x in primes_l)
    delta = q_l // p.t
    vals = [delta * (int(v) % p.t) for v in lut]
    tc = np.zeros((kl, n), dtype=_U)
    for i, pi in enumerate(primes_l):
        pi = int(pi)
        for m in range(1, m_max):
            tc[i, (m - 1) * S: m * S] = vals[m] % pi
        tc[i, n - S:] = (-vals[0]) % pi
    return jnp.asarray(tc)[:, None, :]


# ---------------------------------------------------------------------------
# the composed pipeline
# ---------------------------------------------------------------------------


def keyswitch_keygen(ctx: SchemeContext, key: jax.Array, sk_from: SecretKey,
                     sk_to: SecretKey) -> jax.Array:
    """Keys encrypting (q/q_j) * s_from under s_to (for the pipeline's final
    RLWE' -> RLWE conversion, reference ``key_switch`` decl
    ``include/fhe.cuh:134-135``)."""
    return _bfv._keyswitch_keygen(ctx, key, sk_to, sk_from.data)


def bootstrap_binary(ctx: SchemeContext, key: jax.Array, ct: Ciphertext,
                     sk: SecretKey, bsk: BootstrapKey | None = None,
                     ks_keys: jax.Array | None = None) -> Ciphertext:
    """Noise refresh for a BINARY plaintext (constant coefficient in {0,1}),
    composing the declared pipeline end to end:

        extract_lsb -> blind_rotate -> modulus_raise -> key_switch

    Unlike the reference's decrypt-re-encrypt ``bootstrap`` (whose declared
    sk argument we honor for key generation only), the plaintext bit is
    never exposed: it travels through the LWE sample and the encrypted
    accumulator rotation.  Returns a level-0 ciphertext of the same bit
    with noise independent of the input noise."""
    p = ctx.params
    level = ct.level
    if bsk is not None and bsk.level != level:
        raise ValueError(
            f"bootstrap key level {bsk.level} != ciphertext level {level}: "
            "the accumulator ring and the offset/raise arithmetic must use "
            "the same modulus chain position")
    k1, k2 = jax.random.split(key)

    # 1. extract (at the input's level — fewer primes, cheaper rotation)
    lwe = extract_lsb(ctx, ct, index=0)

    # 2. blind-rotate the sign test vector
    out = blind_rotate(ctx, lwe, bsk, sk=sk, key=k1, level=level)

    # offset by c = floor(Delta/2): plateaus {-c, +c} -> {0, 2c ~ Delta}
    kl = ctx.k - level
    primes_l = p.q_primes[:kl]
    q_l = math.prod(int(x) for x in primes_l)
    c = (q_l // p.t) // 2
    tb = _bfv._tb(ctx, level)
    cvec = jnp.asarray(np.array([c % int(pi) for pi in primes_l], dtype=_U))
    c0 = out.data[:, 0].at[:, 0].set(
        mm.add_mod(out.data[:, 0, 0], cvec, tb.p))
    out = out.replace(data=jnp.concatenate(
        [c0[:, None, :], out.data[:, 1:]], axis=1))

    # 3. modulus raise back to the full basis (include/fhe.cuh:140), then
    # scalar-multiply by q_drop = q_0/q_level: this rescales the plaintext
    # from Delta_level to ~Delta_0 AND annihilates the base-extension
    # alpha*q_level error (alpha*q_level*q_drop = alpha*q_0 = 0 mod q_0) —
    # the standard BFV modulus-raise trick.  Residual noise: q_drop * e.
    if level:
        lv_rot = _noise.bfv_variance(p, level, out.noise_budget)
        out = _bfv.modulus_raise(ctx, out)
        q_drop = math.prod(int(x) for x in p.q_primes[kl:])
        tb0 = ctx.ntt_q
        drop_res = jnp.asarray(np.array(
            [q_drop % int(pi) for pi in p.q_primes], dtype=_U))
        out = out.replace(
            data=_poly.mul_scalar(out.data, drop_res, tb0),
            noise_budget=jnp.maximum(0.0, _noise.bfv_budget(
                p, 0, 2.0 * math.log2(q_drop) + lv_rot)))

    # 4. key switch RLWE' -> RLWE (self-keyed here: the rotation already
    # lands under the scheme key; the switch matches the declared pipeline
    # and re-randomizes the ciphertext under fresh encryption randomness)
    if ks_keys is None:
        ks_keys = keyswitch_keygen(ctx, k2, sk, sk)
    out = _bfv.key_switch(ctx, out, ks_keys)
    return out.replace(noise_budget=jnp.maximum(0.0, _noise.bfv_budget(
        p, 0,
        _noise.add(_noise.bfv_variance(p, 0, out.noise_budget),
                   _noise.keyswitch_add(p, 0)))))


def bootstrap_lut(ctx: SchemeContext, key: jax.Array, ct: Ciphertext,
                  lut, sk: SecretKey, payload_bits: int | None = None,
                  bsk: BootstrapKey | None = None,
                  ks_keys: jax.Array | None = None) -> Ciphertext:
    """PROGRAMMABLE bootstrap (functional/LUT; beyond the binary refresh):
    the output encrypts ``lut[m]`` at fresh noise for a constant-coefficient
    plaintext m in [0, len(lut)) — any function of a small payload is
    evaluated DURING the refresh, for free.

        extract_payload -> blind_rotate(plateau LUT test vector)
            -> modulus_raise -> key_switch

    ``lut``: 2^(w-1) values mod t (w = payload_bits; defaults to the
    smallest width fitting the table).  The top payload bit is the
    negacyclic padding bit, so plaintexts must stay below len(lut).
    lut = [0, 1] reproduces bootstrap_binary's semantics (identity on a
    bit); lut = [1, 0] is encrypted NOT; a 4-entry table computes any
    Z_t-valued function of a 2-bit payload."""
    p = ctx.params
    n = p.n
    level = ct.level
    if payload_bits is None:
        payload_bits = max(1, (len(lut) - 1).bit_length()) + 1
    m_max = 1 << (payload_bits - 1)
    if len(lut) != m_max:
        lut = list(lut) + [0] * (m_max - len(lut))
    if bsk is not None and bsk.level != level:
        raise ValueError(
            f"bootstrap key level {bsk.level} != ciphertext level {level}")
    k1, k2 = jax.random.split(key)

    S = (2 * n) >> payload_bits
    lwe = extract_payload(ctx, ct, payload_bits, index=0)
    tv = _lut_test_poly(ctx, level, lut, payload_bits)
    out = blind_rotate(ctx, lwe, bsk, sk=sk, key=k1, test_poly=tv,
                       offset=S // 2, level=level)
    # no plateau recentering needed: the LUT plateaus already sit at
    # Delta * lut[m] (the binary pipeline's +Delta/2 shift is the
    # lut = [-1/2, +1/2] special case)

    kl = ctx.k - level
    if level:
        lv_rot = _noise.bfv_variance(p, level, out.noise_budget)
        out = _bfv.modulus_raise(ctx, out)
        q_drop = math.prod(int(x) for x in p.q_primes[kl:])
        drop_res = jnp.asarray(np.array(
            [q_drop % int(pi) for pi in p.q_primes], dtype=_U))
        out = out.replace(
            data=_poly.mul_scalar(out.data, drop_res, ctx.ntt_q),
            noise_budget=jnp.maximum(0.0, _noise.bfv_budget(
                p, 0, 2.0 * math.log2(q_drop) + lv_rot)))
    if ks_keys is None:
        ks_keys = keyswitch_keygen(ctx, k2, sk, sk)
    out = _bfv.key_switch(ctx, out, ks_keys)
    return out.replace(noise_budget=jnp.maximum(0.0, _noise.bfv_budget(
        p, 0,
        _noise.add(_noise.bfv_variance(p, 0, out.noise_budget),
                   _noise.keyswitch_add(p, 0)))))
