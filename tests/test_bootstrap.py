"""Bootstrapping pipeline (round-1 review item 1): extract_lsb +
blind_rotate composed with modulus_raise + key_switch, oracle-checked.

Reference: include/fhe.cuh:138-140 (declared-only helpers) and the README
"Bootstrapping Implementation" pipeline.  Small parameters: the blind
rotation is 2n external products.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.random as jrandom

from fhe_jax import FHE, oracle
from fhe_jax.params import SecurityParams, make_scheme_params
from fhe_jax.scheme import bfv, bootstrap
from fhe_jax.scheme.context import make_context


@pytest.fixture(scope="module")
def setup():
    params = make_scheme_params(SecurityParams(
        poly_degree=256, log_q=120, lambda_=0, hamming_weight=16))
    ctx = make_context(params)
    key = jrandom.PRNGKey(3)
    kg, kb = jrandom.split(key)
    pk, sk = jax.jit(bfv.keygen)(ctx, kg)
    return params, ctx, pk, sk, kb


def _encrypt_bit(ctx, pk, bit, key):
    """Bit in the constant coefficient (coefficient encoding)."""
    from fhe_jax.scheme.types import Plaintext
    data = np.zeros(ctx.n, dtype=np.uint32)
    data[0] = bit
    return jax.jit(bfv.encrypt)(ctx, key, pk, Plaintext(data=jnp.asarray(data)))


def _encrypt_payload(ctx, pk, m, key):
    from fhe_jax.scheme.types import Plaintext
    data = np.zeros(ctx.n, dtype=np.uint32)
    data[0] = m
    return jax.jit(bfv.encrypt)(ctx, key, pk,
                                Plaintext(data=jnp.asarray(data)))


def test_bootstrap_lut_identity_and_not(setup):
    """Programmable bootstrap, 1-bit payload: lut=[0,1] refreshes the bit
    (binary semantics), lut=[1,0] is encrypted NOT — both with fresh
    noise and coefficient-0 residual << Delta."""
    params, ctx, pk, sk, kb = setup
    bsk = bootstrap.make_bootstrap_key(ctx, jrandom.fold_in(kb, 50), sk, 0)
    ks = bootstrap.keyswitch_keygen(ctx, jrandom.fold_in(kb, 51), sk, sk)
    for bit in (0, 1):
        ct = _encrypt_payload(ctx, pk, bit, jrandom.fold_in(kb, 60 + bit))
        for lut, want in (([0, 1], bit), ([1, 0], 1 - bit)):
            out = bootstrap.bootstrap_lut(
                ctx, jrandom.fold_in(kb, 70 + bit), ct, lut, sk,
                bsk=bsk, ks_keys=ks)
            dec = np.asarray(bfv.decrypt(ctx, out, sk).data)
            assert int(dec[0]) == want, (bit, lut, dec[0])


def test_bootstrap_lut_two_bit_table(setup):
    """2-bit payload (payload_bits=3): an arbitrary 4-entry table —
    squaring mod 5 here — is evaluated during the refresh."""
    params, ctx, pk, sk, kb = setup
    bsk = bootstrap.make_bootstrap_key(ctx, jrandom.fold_in(kb, 80), sk, 0)
    ks = bootstrap.keyswitch_keygen(ctx, jrandom.fold_in(kb, 81), sk, sk)
    lut = [(m * m) % 5 for m in range(4)]          # [0, 1, 4, 4]
    for m in range(4):
        ct = _encrypt_payload(ctx, pk, m, jrandom.fold_in(kb, 90 + m))
        out = bootstrap.bootstrap_lut(
            ctx, jrandom.fold_in(kb, 95 + m), ct, lut, sk,
            bsk=bsk, ks_keys=ks)
        dec = np.asarray(bfv.decrypt(ctx, out, sk).data)
        assert int(dec[0]) == lut[m], (m, lut, dec[0])
        assert float(out.noise_budget) > 0


def test_extract_lsb_phase(setup):
    """The extracted LWE sample's phase must be ~n*bit mod 2n."""
    params, ctx, pk, sk, kb = setup
    n = params.n
    s_coeff = np.asarray(bfv._inv_q(ctx, sk.data)[:, 0])  # [k, n]
    p0 = int(np.asarray(ctx.ntt_q.p)[0])
    s_int = np.where(s_coeff[0] == 1, 1,
                     np.where(s_coeff[0] == p0 - 1, -1, 0)).astype(np.int64)
    for bit in (0, 1):
        ct = _encrypt_bit(ctx, pk, bit, jrandom.fold_in(kb, bit))
        lwe = bootstrap.extract_lsb(ctx, ct)
        a = np.asarray(lwe.a).astype(np.int64)
        b = int(lwe.b)
        phase = (b + int((a * s_int).sum())) % (2 * n)
        # distance from n*bit must be < n/2
        target = n * bit
        dist = min((phase - target) % (2 * n), (target - phase) % (2 * n))
        assert dist < n // 2, (bit, phase)


@pytest.mark.parametrize("bit", [0, 1])
def test_bootstrap_binary_roundtrip(setup, bit):
    params, ctx, pk, sk, kb = setup
    ct = _encrypt_bit(ctx, pk, bit, jrandom.fold_in(kb, 10 + bit))
    out = bootstrap.bootstrap_binary(ctx, jrandom.fold_in(kb, 20 + bit),
                                     ct, sk)
    # decrypt and check the constant coefficient
    pt = jax.jit(bfv.decrypt)(ctx, out, sk)
    got = int(np.asarray(pt.data)[0])
    assert got == bit
    assert out.level == 0
    # Only coefficient 0 is the payload (documented limit: the other
    # coefficients carry test-vector plateaus at ~Delta/2).  Its residual
    # against Delta*bit must leave several bits of margin.
    from fhe_jax.ops import rns as _rns
    q = math.prod(params.q_primes)
    delta = q // params.t
    phase = np.asarray(bfv._phase(ctx, out, sk))
    coeff0 = _rns.from_rns_host(phase[:, :1], params.q_primes)[0]
    v = (coeff0 - delta * bit) % q
    v = v if v <= q // 2 else q - v
    assert v < delta // 16, f"payload noise {v} vs delta {delta}"


def test_bootstrap_refreshes_leveled_ct(setup):
    """A level-1 input: the pipeline must modulus-raise back to level 0 and
    still decrypt to the right bit (exercises the full declared chain)."""
    params, ctx, pk, sk, kb = setup
    ct = _encrypt_bit(ctx, pk, 1, jrandom.fold_in(kb, 30))
    ct1 = bfv.mod_switch_to_next(ctx, ct)
    assert ct1.level == 1
    out = bootstrap.bootstrap_binary(ctx, jrandom.fold_in(kb, 31), ct1, sk)
    assert out.level == 0
    got = int(np.asarray(jax.jit(bfv.decrypt)(ctx, out, sk).data)[0])
    assert got == 1


def test_api_wrapper_exposes_declared_helpers():
    """The FHE wrapper mirrors FHEContext method-for-method: key_switch,
    extract_lsb, blind_rotate, modulus_raise (include/fhe.cuh:134-140) must
    be callable from the high-level object, not just the scheme layer."""
    from fhe_jax import FHE
    params = make_scheme_params(SecurityParams(
        poly_degree=256, log_q=120, lambda_=0, hamming_weight=16))
    fhe = FHE(params, seed=7)
    pk, sk = fhe.keygen()
    v = np.zeros(params.n, dtype=np.int64)
    v[0] = 1
    ct = fhe.encrypt(fhe.encode_coeff(v), pk)

    lwe = fhe.extract_lsb(ct)
    acc = fhe.blind_rotate(lwe, sk=sk)
    assert acc.level == 0 and acc.num_components == 2

    ct1 = fhe.mod_switch_to_next(ct)
    raised = fhe.modulus_raise(ct1)
    assert raised.level == 0

    from fhe_jax.scheme import bootstrap as _bs
    ks = _bs.keyswitch_keygen(fhe.ctx, jrandom.PRNGKey(99), sk, sk)
    sw = fhe.key_switch(ct, ks)
    got = fhe.decode_coeff(fhe.decrypt(sw, sk)).astype(np.int64)
    assert got[0] == 1 and not got[1:].any()


def test_blind_rotate_lookup(setup):
    """Programmable bootstrap: a custom test polynomial evaluates a lookup
    at the LWE phase (coefficient 0 of X^{n/2-u} * testv)."""
    params, ctx, pk, sk, kb = setup
    n = params.n
    ct = _encrypt_bit(ctx, pk, 1, jrandom.fold_in(kb, 40))
    lwe = bootstrap.extract_lsb(ctx, ct)
    # testv with distinct constants per index region: f(k) = k-th coeff
    q_l = math.prod(params.q_primes)
    marker = 12345
    vals = np.stack([np.full(n, marker % int(pi), dtype=np.uint32)
                     for pi in params.q_primes])
    out = bootstrap.blind_rotate(
        ctx, lwe, sk=sk, key=jrandom.fold_in(kb, 41),
        test_poly=jnp.asarray(vals)[:, None, :])
    # phase(acc) = X^{n/2-u} * testv; with constant-vector testv the
    # constant coefficient is +-marker; for bit=1 (u ~ n) it lands +marker
    phase = np.asarray(bfv._phase(ctx, out, sk))  # [k, n] residues
    from fhe_jax.ops import rns as _rns
    coeff0 = _rns.from_rns_host(phase[:, :1], params.q_primes)[0]
    centered = coeff0 if coeff0 <= q_l // 2 else coeff0 - q_l
    assert abs(centered - marker) < (1 << 46), centered


def test_bootstrap_binary_batch_matches_single(setup):
    """B bootstraps through ONE batched blind rotation:
    each output decrypts to its input bit with the same payload-noise
    margin as the single path, and the batched monomial rotation
    (gather-free bit-decomposed rolls) is bit-exact with the single-path
    accumulator math."""
    params, ctx, pk, sk, kb = setup
    bits = [1, 0, 1, 0]
    cts = [_encrypt_bit(ctx, pk, b, jrandom.fold_in(kb, 40 + i))
           for i, b in enumerate(bits)]
    bsk = bootstrap.make_bootstrap_key(ctx, jrandom.fold_in(kb, 50), sk, 0)
    ksk = bootstrap.keyswitch_keygen(ctx, jrandom.fold_in(kb, 51), sk, sk)
    outs = jax.jit(bootstrap.bootstrap_binary_batch)(ctx, cts, bsk, ksk)
    for b, out in zip(bits, outs):
        pt = jax.jit(bfv.decrypt)(ctx, out, sk)
        assert int(np.asarray(pt.data)[0]) == b
        assert out.level == 0
    # the batched accumulator equals the single-path accumulator bit-exactly
    # (same bsk, same CMUX schedule — only the monomial-mul implementation
    # differs, which must not change a single residue)
    lwe0 = bootstrap.extract_lsb(ctx, cts[0], index=0)
    acc_single = bootstrap.blind_rotate(ctx, lwe0, bsk)
    a_b = jnp.stack([bootstrap.extract_lsb(ctx, c, 0).a for c in cts])
    b_b = jnp.stack([bootstrap.extract_lsb(ctx, c, 0).b for c in cts])
    acc_batch = bootstrap.blind_rotate_batch(ctx, a_b, b_b, bsk)
    np.testing.assert_array_equal(np.asarray(acc_batch[:, 0]),
                                  np.asarray(acc_single.data))


def test_monomial_mul_bits_matches_take(setup):
    """The bit-decomposed negacyclic monomial multiply == the gather form,
    for every shift in [0, 2n)."""
    params, ctx, pk, sk, kb = setup
    n = 32
    p = jnp.asarray(np.array([97], dtype=np.uint32))[:, None, None]
    x = jnp.asarray(np.arange(2 * n, dtype=np.uint32).reshape(1, 2, n) % 97)
    p4 = p[..., None]
    for r in range(2 * n):
        want = np.asarray(bootstrap._monomial_mul(
            x, jnp.uint32(r), n, p))
        got = np.asarray(bootstrap._monomial_mul_bits(
            x[:, None], jnp.asarray([r], dtype=np.uint32), n, p4))[:, 0]
        np.testing.assert_array_equal(got, want, err_msg=f"r={r}")
