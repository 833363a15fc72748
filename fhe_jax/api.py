"""High-level FHE API — drop-in surface for users of the reference library.

Mirrors ``fhe::FHEContext`` method-for-method (``include/fhe.cuh:78-148``) as
a thin object wrapper over the functional scheme layer, with every heavy op
jit-compiled once per (params, shape).  Encode defaults to SIMD slot encoding
because the reference's own test expectations assume slot-wise homomorphic
semantics (tests/test_fhe.cu:264,270); coefficient encoding is available via
``encode_coeff``/``decode_coeff``.

    from fhe_jax import FHE
    fhe = FHE(poly_degree=4096, log_q=120)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    ct = fhe.encrypt(fhe.encode([1, 2, 3]), pk)
    out = fhe.decode(fhe.decrypt(fhe.multiply(ct, ct, rlk), sk))
"""

from __future__ import annotations

import functools

import numpy as np
import jax

from .params import SecurityParams, SchemeParams, make_scheme_params
from .scheme import bfv, bgv, encoder as _encoder
from .scheme.context import SchemeContext, make_context
from .scheme.types import (Ciphertext, GaloisKeys, Plaintext, PublicKey,
                           RelinKeys, SecretKey)
from .utils.perf import PerformanceMonitor


class FHE:
    """Stateful convenience wrapper.

    Mutable state: the PRNG counter, the performance monitor, and the
    per-level relinearization-key cache (GIL-safe; guard externally on
    free-threaded Python when sharing one instance across threads).  All
    scheme state (context, keys, ciphertexts) is immutable."""

    def __init__(self, params: SchemeParams | None = None, seed: int = 0,
                 scheme: str = "bfv", use_mxu: bool = False, **security_kw):
        if params is None:
            params = make_scheme_params(SecurityParams(**security_kw))
        if scheme not in ("bfv", "bgv"):
            raise ValueError(f"unknown scheme {scheme!r}; use 'bfv' or 'bgv'")
        self.scheme_name = scheme
        mod = bfv if scheme == "bfv" else bgv
        self._scheme = mod
        self.params = params
        self.ctx: SchemeContext = make_context(params, use_mxu=use_mxu)
        self._key = jax.random.PRNGKey(seed)
        self.encoder = _encoder.BatchEncoder(params)
        self.monitor = PerformanceMonitor()
        # jit caches
        self._keygen = jax.jit(mod.keygen)
        self._relinkey = jax.jit(mod.relinkey_gen)
        self._encrypt = jax.jit(mod.encrypt)
        self._decrypt = jax.jit(mod.decrypt)
        self._add = jax.jit(mod.add)
        self._sub = jax.jit(mod.sub)
        self._add_plain = jax.jit(mod.add_plain)
        self._sub_plain = jax.jit(mod.sub_plain)
        self._mul_plain = jax.jit(mod.multiply_plain)
        self._multiply = jax.jit(mod.multiply)
        self._multiply_no_relin = jax.jit(mod.multiply_no_relin)
        self._relinearize = jax.jit(mod.relinearize)
        self._mod_switch = jax.jit(mod.mod_switch_to_next)
        self._multiply_lv = jax.jit(
            functools.partial(mod.multiply, keys_at_level=True))
        self._relinearize_lv = jax.jit(
            functools.partial(mod.relinearize, keys_at_level=True))
        self._switch_rlk = jax.jit(
            functools.partial(bfv.switch_relin_keys,
                              bgv=scheme == "bgv"),
            static_argnames=("level",))
        # (id(keys), level) -> switched keys; weakref.finalize evicts every
        # entry for a key object when the caller drops it, so the caches
        # neither pin dead keys in HBM nor grow unboundedly
        self._rlk_cache: dict = {}
        self._gal_cache: dict = {}
        self._bootstrap_ks_cache: dict = {}
        self._plain_ntt_cache: dict = {}
        self._to_ntt = jax.jit(mod.to_ntt)
        self._to_coeff = jax.jit(mod.to_coeff)
        # memoized jits for entry points with static knobs (steps, element
        # tuples, batch sizes): eager execution would dispatch every
        # primitive separately
        self._jit_cache: dict = {}

    def _jit(self, key: tuple, make):
        """Memoized jax.jit(make()) per static-config key."""
        j = self._jit_cache.get(key)
        if j is None:
            j = jax.jit(make())
            self._jit_cache[key] = j
        return j

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    # -- keys (reference src/fhe.cu:54-111) --
    def keygen(self) -> tuple[PublicKey, SecretKey]:
        with self.monitor.time("keygen"):
            return self._keygen(self.ctx, self._next_key())

    def relinkey_gen(self, sk: SecretKey) -> RelinKeys:
        with self.monitor.time("relinkey_gen"):
            return self._relinkey(self.ctx, self._next_key(), sk)

    def galoiskey_gen(self, sk: SecretKey, elements=None) -> GaloisKeys:
        with self.monitor.time("galoiskey_gen"):
            return self._scheme.galoiskey_gen(self.ctx, self._next_key(), sk, elements)

    # -- encoding (slot semantics by default; see module docstring) --
    def encode(self, values) -> Plaintext:
        return self.encoder.encode(values)

    def decode(self, pt: Plaintext) -> np.ndarray:
        return self.encoder.decode(pt)

    def encode_coeff(self, values) -> Plaintext:
        return _encoder.encode_coeff(self.params, values)

    def decode_coeff(self, pt: Plaintext) -> np.ndarray:
        return _encoder.decode_coeff(self.params, pt)

    @property
    def slot_count(self) -> int:
        return self.encoder.slot_count

    # -- encrypt/decrypt (reference src/fhe.cu:138-185) --
    def encrypt(self, pt: Plaintext, pk: PublicKey) -> Ciphertext:
        with self.monitor.time("encrypt"):
            return self._encrypt(self.ctx, self._next_key(), pk, pt)

    def decrypt(self, ct: Ciphertext, sk: SecretKey) -> Plaintext:
        with self.monitor.time("decrypt"):
            return self._decrypt(self.ctx, ct, sk)

    def encrypt_batch(self, pts: list, pk: PublicKey) -> list:
        """Encrypt B plaintexts in one jitted call (element i is an
        independent fresh encryption; bfv.encrypt_batch)."""
        fn = getattr(self._scheme, "encrypt_batch", None)
        if fn is None:
            return [self.encrypt(pt, pk) for pt in pts]
        j = self._jit(("encrypt_batch", len(pts)), lambda: fn)
        with self.monitor.time("encrypt_batch"):
            return j(self.ctx, self._next_key(), pk, pts)

    def decrypt_batch(self, cts: list, sk: SecretKey) -> list:
        """Decrypt B ciphertexts in one jitted call (bfv.decrypt_batch);
        element i == decrypt(cts[i], sk)."""
        fn = getattr(self._scheme, "decrypt_batch", None)
        if fn is None:
            return [self.decrypt(ct, sk) for ct in cts]
        j = self._jit(("decrypt_batch", len(cts)), lambda: fn)
        with self.monitor.time("decrypt_batch"):
            return j(self.ctx, cts, sk)

    # -- homomorphic ops --
    def add(self, a, b):
        with self.monitor.time("add"):
            return self._add(self.ctx, a, b)

    def sub(self, a, b):
        with self.monitor.time("sub"):
            return self._sub(self.ctx, a, b)

    def add_plain(self, ct, pt):
        return self._add_plain(self.ctx, ct, pt)

    def sub_plain(self, ct, pt):
        return self._sub_plain(self.ctx, ct, pt)

    def multiply_plain(self, ct, pt, cache_operand: bool = False):
        """cache_operand=True precomputes (and caches per (pt, level)) the
        NTT-form operand, so repeated products by the SAME Plaintext object
        skip its forward transform — combined with to_ntt residency this
        makes a K-term plaintext dot product cost 1 NTT + 1 INTT total
        instead of K round trips."""
        op = self.plain_operand(pt, ct.level) if cache_operand else None
        return self._mul_plain(self.ctx, ct, pt, op)

    # -- NTT-form residency (reference include/fhe.cuh:68 `is_ntt_form`) --
    def to_ntt(self, ct):
        """Convert to evaluation (NTT) domain.  add/sub/add_plain/sub_plain/
        multiply_plain all operate domain-resident; key-switching ops
        (multiply, rotations) and decrypt convert back internally."""
        return self._to_ntt(self.ctx, ct)

    def to_coeff(self, ct):
        return self._to_coeff(self.ctx, ct)

    def plain_operand(self, pt, level: int = 0):
        """Cached NTT-form multiply_plain operand for a reused Plaintext
        (evicted when the caller drops the Plaintext object)."""
        ck = (id(pt), level)
        op = self._plain_ntt_cache.get(ck)
        if op is None:
            import weakref
            with self.monitor.time("plain_ntt_operand"):
                op = bfv.plain_ntt_operand(self.ctx, pt, level)
            self._plain_ntt_cache[ck] = op
            pid = id(pt)
            weakref.finalize(
                pt, lambda c=self._plain_ntt_cache, i=pid: [
                    c.pop(kk) for kk in list(c) if kk[0] == i])
        return op

    def _keys_at(self, cache: dict, keys, level: int, switch_fn, label: str):
        """Per-level key cache with weakref eviction (shared by relin and
        Galois key material)."""
        if level == 0:
            return keys
        ck = (id(keys), level)
        switched = cache.get(ck)
        if switched is None:
            import weakref
            with self.monitor.time(label):
                switched = switch_fn(keys, level)
            cache[ck] = switched
            kid = id(keys)
            weakref.finalize(
                keys, lambda c=cache, i=kid: [
                    c.pop(kk) for kk in list(c) if kk[0] == i])
        return switched

    def _rlk_at(self, rlk: RelinKeys, level: int) -> RelinKeys:
        return self._keys_at(
            self._rlk_cache, rlk, level,
            lambda k, lv: self._switch_rlk(self.ctx, k, level=lv),
            "switch_relin_keys")

    def _gal_at(self, gal: GaloisKeys, level: int) -> GaloisKeys:
        return self._keys_at(
            self._gal_cache, gal, level,
            lambda k, lv: bfv.switch_galois_keys(
                self.ctx, k, lv, bgv=self.scheme_name == "bgv"),
            "switch_galois_keys")

    def multiply(self, a, b, rlk: RelinKeys):
        if a.level:
            rlk_l = self._rlk_at(rlk, a.level)
            with self.monitor.time("multiply"):
                return self._multiply_lv(self.ctx, a, b, rlk_l)
        with self.monitor.time("multiply"):
            return self._multiply(self.ctx, a, b, rlk)

    def multiply_batch(self, cts_a, cts_b, rlk: RelinKeys):
        """Multiply+relinearize B independent ciphertext pairs in one jitted
        call (scheme.bfv.multiply_batch); element i ==
        multiply(cts_a[i], cts_b[i])."""
        fn = getattr(self._scheme, "multiply_batch", None)
        if fn is None:  # scheme without a batched path (bgv): compose
            return [self.multiply(a, b, rlk) for a, b in zip(cts_a, cts_b)]
        level = cts_a[0].level if cts_a else 0
        rlk_l = self._rlk_at(rlk, level) if level else rlk
        j = self._jit(("multiply_batch", bool(level)),
                      lambda kal=bool(level): lambda ctx, a, b, r:
                      fn(ctx, a, b, r, keys_at_level=kal))
        with self.monitor.time("multiply_batch"):
            return j(self.ctx, cts_a, cts_b, rlk_l)

    def multiply_no_relin(self, a, b):
        return self._multiply_no_relin(self.ctx, a, b)

    def relinearize(self, ct, rlk: RelinKeys):
        if ct.level:
            rlk_l = self._rlk_at(rlk, ct.level)
            with self.monitor.time("relinearize"):
                return self._relinearize_lv(self.ctx, ct, rlk_l)
        with self.monitor.time("relinearize"):
            return self._relinearize(self.ctx, ct, rlk)

    # -- rotations --
    def rotate_rows(self, ct, steps: int, gal_keys: GaloisKeys):
        if ct.level:
            gal_keys = self._gal_at(gal_keys, ct.level)
        rot = self._scheme.rotate_rows
        j = self._jit(("rotate_rows", int(steps), ct.level > 0),
                      lambda s=int(steps), kal=ct.level > 0:
                      lambda ctx, c, gk: rot(ctx, c, s, gk,
                                             keys_at_level=kal))
        with self.monitor.time("rotate"):
            return j(self.ctx, ct, gal_keys)

    def rotate_rows_batch(self, cts, steps: int, gal_keys: GaloisKeys):
        """Rotate B independent ciphertexts by the same step count in one
        jitted call (bfv.rotate_rows_batch); element i ==
        rotate_rows(cts[i], steps)."""
        fn = getattr(self._scheme, "rotate_rows_batch", None)
        if fn is None:
            return [self.rotate_rows(ct, steps, gal_keys) for ct in cts]
        level = cts[0].level if cts else 0
        if level:
            gal_keys = self._gal_at(gal_keys, level)
        j = self._jit(("rotate_rows_batch", int(steps), level > 0),
                      lambda s=int(steps), kal=level > 0:
                      lambda ctx, c, gk: fn(ctx, c, s, gk,
                                            keys_at_level=kal))
        with self.monitor.time("rotate_batch"):
            return j(self.ctx, cts, gal_keys)

    def rotate_rows_hoisted(self, ct, steps_list, gal_keys: GaloisKeys):
        """Many rotations of ONE ciphertext sharing a single hoisted gadget
        decomposition (each step must have a direct Galois key: generate
        with galoiskey_gen(sk, elements=[pow(3, s, 2n) for s in steps]))."""
        m = 2 * self.params.n
        elements = tuple(pow(3, int(s), m) for s in steps_list)
        for g in elements:
            if g not in gal_keys.data:
                raise KeyError(
                    f"no galois key for element {g}; generate with "
                    f"galoiskey_gen(sk, elements={list(elements)})")
        level = ct.level
        if level:
            gal_keys = self._gal_at(gal_keys, level)
        agh = self._scheme.apply_galois_hoisted
        j = self._jit(
            ("rotate_rows_hoisted", elements, level > 0),
            lambda es=elements, kal=level > 0:
            lambda ctx, c, gk: agh(
                ctx, c, es, gk, bgv=self.scheme_name == "bgv",
                keys_at_level=kal))
        with self.monitor.time("rotate_hoisted"):
            return j(self.ctx, ct, gal_keys)

    def rotate_rows_hoisted_batch(self, cts, steps_list,
                                  gal_keys: GaloisKeys):
        """Hoisted rotations of C INDEPENDENT ciphertexts by the same step
        set in one jitted call (bfv.apply_galois_hoisted_batch): outs[c][e] ==
        rotate_rows(cts[c], steps_list[e]) up to digit representatives.
        Key requirements match rotate_rows_hoisted (direct Galois keys)."""
        m = 2 * self.params.n
        elements = tuple(pow(3, int(s), m) for s in steps_list)
        for g in elements:
            if g not in gal_keys.data:
                raise KeyError(
                    f"no galois key for element {g}; generate with "
                    f"galoiskey_gen(sk, elements={list(elements)})")
        if not cts:
            return []
        # fallback decisions use the ORIGINAL gal_keys: rotate_rows_hoisted
        # does its own level switching, and a pre-switched object here would
        # be switched a second time (id-keyed cache miss -> wrong keys)
        fn = getattr(self._scheme, "apply_galois_hoisted_batch", None)
        levels = {ct.level for ct in cts}
        if fn is None or len(levels) > 1:
            return [self.rotate_rows_hoisted(ct, steps_list, gal_keys)
                    for ct in cts]
        level = cts[0].level
        if level:
            gal_keys = self._gal_at(gal_keys, level)
        j = self._jit(
            ("rotate_rows_hoisted_batch", elements, level > 0, len(cts)),
            lambda es=elements, kal=level > 0:
            lambda ctx, c, gk: fn(
                ctx, c, es, gk, bgv=self.scheme_name == "bgv",
                keys_at_level=kal))
        with self.monitor.time("rotate_hoisted_batch"):
            return j(self.ctx, cts, gal_keys)

    def sum_slots_elements(self) -> tuple:
        """Galois elements enabling the FAST sum_slots: the default
        power-of-two set plus the 3*4^i hops each radix-4 stage hoists.
        Pass to galoiskey_gen(sk, elements=fhe.sum_slots_elements())."""
        from .scheme import context as _context
        m = 2 * self.params.n
        half = self.params.n // 2
        elems = list(_context.default_galois_elements(self.params.n))
        step = 1
        while step < half:
            for j in (2, 3):
                if j * step < half:
                    elems.append(pow(3, j * step, m))
            step *= 4
        return tuple(dict.fromkeys(elems))

    def sum_slots(self, ct, gal_keys: GaloisKeys):
        """Every slot becomes the sum of ALL slots (inner-sum reduction).

        With keys from sum_slots_elements(), each reduction stage hoists
        the three rotations {s, 2s, 3s} of the running sum through ONE
        shared gadget decomposition (radix-4: log4 instead of log2 stages;
        the stages themselves are data-dependent and cannot be hoisted
        across).  With the default power-of-two key set it falls back to
        the classic log2 rotate-and-add sweep."""
        m = 2 * self.params.n
        half = self.params.n // 2
        with self.monitor.time("sum_slots"):
            step = 1
            while step < half:
                group = [j * step for j in (1, 2, 3) if j * step < half]
                gs = [pow(3, s, m) for s in group]
                if len(gs) > 1 and all(g in gal_keys.data for g in gs):
                    ct = self._rotate_accumulate(ct, group, gal_keys)
                    step *= len(group) + 1
                else:
                    ct = self.add(ct, self.rotate_rows(ct, step, gal_keys))
                    step *= 2
            return self.add(ct, self.rotate_columns(ct, gal_keys))

    def _rotate_accumulate(self, ct, steps_list, gal_keys: GaloisKeys):
        """ct + sum_s rotate_rows(ct, s) through one hoisted accumulating
        chain (bfv.apply_galois_hoisted_sum) — the sum_slots stage body."""
        m = 2 * self.params.n
        elements = tuple(pow(3, int(s), m) for s in steps_list)
        level = ct.level
        if level:
            gal_keys = self._gal_at(gal_keys, level)
        ags = self._scheme.apply_galois_hoisted_sum
        j = self._jit(
            ("rotate_accumulate", elements, level > 0),
            lambda es=elements, kal=level > 0:
            lambda ctx, c, gk: ags(
                ctx, c, es, gk, bgv=self.scheme_name == "bgv",
                keys_at_level=kal))
        return j(self.ctx, ct, gal_keys)

    def rotate_columns(self, ct, gal_keys: GaloisKeys):
        if ct.level:
            gal_keys = self._gal_at(gal_keys, ct.level)
        rc = self._scheme.rotate_columns
        j = self._jit(("rotate_columns", ct.level > 0),
                      lambda kal=ct.level > 0:
                      lambda ctx, c, gk: rc(ctx, c, gk, keys_at_level=kal))
        return j(self.ctx, ct, gal_keys)

    # -- noise management --
    def mod_switch_to_next(self, ct):
        return self._mod_switch(self.ctx, ct)

    def mod_switch_to_level(self, ct, level: int):
        return self._scheme.mod_switch_to_level(self.ctx, ct, level)

    def bootstrap(self, ct, sk: SecretKey, pk: PublicKey):
        with self.monitor.time("bootstrap"):
            return self._scheme.bootstrap(self.ctx, self._next_key(), ct, sk, pk)

    # -- the real bootstrapping pipeline (scheme/bootstrap.py): extract_lsb
    # -> blind_rotate -> modulus_raise -> key_switch (reference
    # include/fhe.cuh:138-140).  BFV only; binary payload in coefficient 0.
    def make_bootstrap_key(self, sk: SecretKey, level: int = 0):
        from .scheme import bootstrap as _bs
        if self.scheme_name != "bfv":
            raise NotImplementedError("bootstrap pipeline is BFV-only")
        with self.monitor.time("make_bootstrap_key"):
            return _bs.make_bootstrap_key(self.ctx, self._next_key(), sk, level)

    def bootstrap_binary(self, ct, sk: SecretKey, bsk=None):
        from .scheme import bootstrap as _bs
        if self.scheme_name != "bfv":
            raise NotImplementedError("bootstrap pipeline is BFV-only")
        # the pipeline's final RLWE'->RLWE switch keys depend only on sk:
        # generate once per secret key and reuse (weakref-evicted like the
        # relin/Galois caches)
        ck = id(sk)
        ks = self._bootstrap_ks_cache.get(ck)
        if ks is None:
            import weakref
            ks = _bs.keyswitch_keygen(self.ctx, self._next_key(), sk, sk)
            self._bootstrap_ks_cache[ck] = ks
            weakref.finalize(
                sk, lambda c=self._bootstrap_ks_cache, i=ck: c.pop(i, None))
        with self.monitor.time("bootstrap_binary"):
            return _bs.bootstrap_binary(self.ctx, self._next_key(), ct, sk,
                                        bsk, ks_keys=ks)

    def bootstrap_lut(self, ct, lut, sk: SecretKey, bsk=None,
                      payload_bits: int | None = None):
        """PROGRAMMABLE bootstrap: refresh a small constant-coefficient
        payload m while evaluating an arbitrary table — the output
        encrypts lut[m] at fresh noise (scheme/bootstrap.bootstrap_lut).
        lut = [0, 1] is the binary refresh; lut = [1, 0] encrypted NOT;
        wider tables evaluate any function of a multi-bit payload."""
        from .scheme import bootstrap as _bs
        if self.scheme_name != "bfv":
            raise NotImplementedError("bootstrap pipeline is BFV-only")
        ck = id(sk)
        ks = self._bootstrap_ks_cache.get(ck)
        if ks is None:
            import weakref
            ks = _bs.keyswitch_keygen(self.ctx, self._next_key(), sk, sk)
            self._bootstrap_ks_cache[ck] = ks
            weakref.finalize(
                sk, lambda c=self._bootstrap_ks_cache, i=ck: c.pop(i, None))
        with self.monitor.time("bootstrap_lut"):
            return _bs.bootstrap_lut(
                self.ctx, self._next_key(), ct, lut, sk,
                payload_bits=payload_bits, bsk=bsk, ks_keys=ks)

    def bootstrap_binary_batch(self, cts: list, sk: SecretKey, bsk) -> list:
        """B independent binary bootstraps through ONE batched blind
        rotation (the 2n external products amortize across the batch);
        element i's plaintext == bootstrap_binary(cts[i])'s."""
        from .scheme import bootstrap as _bs
        if self.scheme_name != "bfv":
            raise NotImplementedError("bootstrap pipeline is BFV-only")
        ck = id(sk)
        ks = self._bootstrap_ks_cache.get(ck)
        if ks is None:
            import weakref
            ks = _bs.keyswitch_keygen(self.ctx, self._next_key(), sk, sk)
            self._bootstrap_ks_cache[ck] = ks
            weakref.finalize(
                sk, lambda c=self._bootstrap_ks_cache, i=ck: c.pop(i, None))
        with self.monitor.time("bootstrap_binary_batch"):
            return _bs.bootstrap_binary_batch(self.ctx, cts, bsk, ks)

    def key_switch(self, ct, ks_keys, keys_at_level: bool = False):
        """Switch a 2-component ct under s' to one under s (reference decl
        ``include/fhe.cuh:134-135``); ks_keys from scheme-layer
        ``bootstrap.keyswitch_keygen`` or ``bfv._keyswitch_keygen``."""
        with self.monitor.time("key_switch"):
            return self._scheme.key_switch(
                self.ctx, ct, ks_keys, bgv=self.scheme_name == "bgv",
                keys_at_level=keys_at_level)

    def modulus_raise(self, ct):
        """Base-extend a leveled ct back to the full q basis (reference decl
        ``include/fhe.cuh:140``).  BFV pipeline helper; follow with the
        q_drop scalar multiply as in bootstrap_binary (scheme/bootstrap.py)
        when used mid-bootstrap."""
        if self.scheme_name != "bfv":
            raise NotImplementedError("modulus_raise is BFV-only")
        with self.monitor.time("modulus_raise"):
            return bfv.modulus_raise(self.ctx, ct)

    def extract_lsb(self, ct, index: int = 0):
        """RLWE -> LWE-over-Z_2n LSB extraction (reference decl
        ``include/fhe.cuh:138``); BFV-only, binary payload in coeff
        ``index``."""
        from .scheme import bootstrap as _bs
        if self.scheme_name != "bfv":
            raise NotImplementedError("bootstrap pipeline is BFV-only")
        with self.monitor.time("extract_lsb"):
            return _bs.extract_lsb(self.ctx, ct, index)

    def blind_rotate(self, lwe, bsk=None, sk: SecretKey | None = None,
                     test_poly=None, level: int = 0):
        """CGGI accumulator blind rotation (reference decl
        ``include/fhe.cuh:139``): pass a precomputed ``bsk``
        (make_bootstrap_key) or ``sk`` to derive one on the fly."""
        from .scheme import bootstrap as _bs
        if self.scheme_name != "bfv":
            raise NotImplementedError("bootstrap pipeline is BFV-only")
        with self.monitor.time("blind_rotate"):
            return _bs.blind_rotate(
                self.ctx, lwe, bsk, sk=sk,
                key=None if sk is None else self._next_key(),
                test_poly=test_poly, level=level)

    def estimate_noise_budget(self, ct, sk: SecretKey) -> float:
        return self._scheme.estimate_noise_budget(self.ctx, ct, sk)

    def exact_noise_budget(self, ct, sk: SecretKey, pt) -> float:
        """Budget measured against a KNOWN expected plaintext — negative
        once the ciphertext is corrupted (no post-exhaustion blind spot)."""
        return self._scheme.exact_noise_budget(self.ctx, ct, sk, pt)
