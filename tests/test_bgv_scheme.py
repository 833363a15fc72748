"""End-to-end BGV scheme tests — real BGV for the reference's "BGV/BFV"
declaration, bit-exact against oracle.BGVOracle where randomness permits.

Covers: round trip, slot-wise add/sub/mul with the reference expected vectors,
plain ops, the exact tensor product (device vs big-int oracle), t-corrected
modulus switching with the scale_t correction factor, rotations, bootstrap,
and noise tracking."""

import numpy as np
import pytest
import jax

from fhe_jax import FHE, oracle
from fhe_jax.params import SecurityParams, make_scheme_params
from fhe_jax.ops import rns as _rns
from fhe_jax.scheme import bgv

PARAMS = make_scheme_params(
    SecurityParams(poly_degree=256, log_q=120, hamming_weight=32))


@pytest.fixture(scope="module")
def fhe():
    return FHE(PARAMS, seed=5, scheme="bgv")


@pytest.fixture(scope="module")
def keys(fhe):
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    return pk, sk, rlk


def test_encrypt_decrypt_roundtrip(fhe, keys):
    pk, sk, _ = keys
    vals = [5, 10, 15, 20]
    ct = fhe.encrypt(fhe.encode(vals), pk)
    got = fhe.decode(fhe.decrypt(ct, sk))
    assert list(got[:4]) == vals
    assert all(v == 0 for v in got[4:])


def test_phase_is_m_plus_t_e(fhe, keys):
    """The defining BGV invariant: [phase]_q = m + t*e with small e."""
    pk, sk, _ = keys
    pt = fhe.encode_coeff([9, 0, 0, 1])
    ct = fhe.encrypt(pt, pk)
    x = np.asarray(bgv._phase(fhe.ctx, ct, sk))
    coeffs = _rns.from_rns_host(x, PARAMS.q_primes)
    q, t = PARAMS.q, PARAMS.t
    for j, c in enumerate(coeffs):
        centered = c if c <= q // 2 else c - q
        m = int(pt.data[j])
        assert (centered - m) % t == 0
        assert abs(centered - m) < q // (t * 4), "noise not t-scaled-small"


def test_homomorphic_add_sub(fhe, keys):
    pk, sk, _ = keys
    ct1 = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    ct2 = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    got = fhe.decode(fhe.decrypt(fhe.add(ct1, ct2), sk))
    assert list(got[:4]) == [8, 16, 24, 32]
    got = fhe.decode(fhe.decrypt(fhe.sub(ct1, ct2), sk))
    assert list(got[:4]) == [2, 4, 6, 8]


def test_homomorphic_multiply_slotwise(fhe, keys):
    pk, sk, rlk = keys
    ct1 = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    ct2 = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    got = fhe.decode(fhe.decrypt(fhe.multiply(ct1, ct2, rlk), sk))
    assert list(got[:4]) == [15, 60, 135, 240]


def test_tensor_product_bit_exact_vs_oracle(fhe, keys):
    """BGV multiply is a plain mod-q tensor product; device must equal the
    big-int oracle exactly."""
    pk, _, _ = keys
    ct1 = fhe.encrypt(fhe.encode([7, 1, 2, 3]), pk)
    ct2 = fhe.encrypt(fhe.encode([4, 5, 6, 9]), pk)
    ct3 = fhe.multiply_no_relin(ct1, ct2)

    def ct_to_bigint(ct):
        return [
            _rns.from_rns_host(np.asarray(ct.data)[:, c, :], PARAMS.q_primes)
            for c in range(ct.data.shape[1])
        ]

    o = oracle.BGVOracle(PARAMS, seed=0)
    want = o.multiply_no_relin(ct_to_bigint(ct1), ct_to_bigint(ct2))
    assert ct_to_bigint(ct3) == want


def test_plain_ops(fhe, keys):
    pk, sk, _ = keys
    ct = fhe.encrypt(fhe.encode([10, 20, 30, 40]), pk)
    pt2 = fhe.encode([2, 2, 2, 2])
    assert list(fhe.decode(fhe.decrypt(fhe.add_plain(ct, pt2), sk))[:4]) == \
        [12, 22, 32, 42]
    assert list(fhe.decode(fhe.decrypt(fhe.sub_plain(ct, pt2), sk))[:4]) == \
        [8, 18, 28, 38]
    assert list(fhe.decode(fhe.decrypt(fhe.multiply_plain(ct, pt2), sk))[:4]) == \
        [20, 40, 60, 80]


def test_mod_switch_scale_factor(fhe, keys):
    """Dropping primes multiplies the underlying plaintext by q_last^-1;
    scale_t must track it so decrypt stays correct at every level."""
    pk, sk, _ = keys
    ct = fhe.encrypt(fhe.encode([9, 8, 7, 6]), pk)
    ct1 = fhe.mod_switch_to_next(ct)
    assert ct1.level == 1
    assert ct1.scale_t == PARAMS.q_primes[-1] % PARAMS.t
    assert list(fhe.decode(fhe.decrypt(ct1, sk))[:4]) == [9, 8, 7, 6]
    ct2 = fhe.mod_switch_to_next(ct1)
    assert ct2.scale_t == (PARAMS.q_primes[-1] * PARAMS.q_primes[-2]) % PARAMS.t
    assert list(fhe.decode(fhe.decrypt(ct2, sk))[:4]) == [9, 8, 7, 6]


def test_mod_switch_bit_exact_vs_oracle(fhe, keys):
    pk, _, _ = keys
    ct = fhe.encrypt(fhe.encode([1, 2, 3]), pk)
    got = fhe.mod_switch_to_next(ct)

    def to_bigint(data, primes):
        return [_rns.from_rns_host(np.asarray(data)[:, c, :], primes)
                for c in range(data.shape[1])]

    o = oracle.BGVOracle(PARAMS, seed=0)
    want = o.mod_switch_drop_last(to_bigint(ct.data, PARAMS.q_primes))
    assert to_bigint(got.data, PARAMS.q_primes[:-1]) == want


def test_multiply_then_mod_switch(fhe, keys):
    """The canonical BGV pattern: multiply, relinearize, switch down."""
    pk, sk, rlk = keys
    ct1 = fhe.encrypt(fhe.encode([5, 10]), pk)
    ct2 = fhe.encrypt(fhe.encode([3, 6]), pk)
    prod = fhe.multiply(ct1, ct2, rlk)
    switched = fhe.mod_switch_to_next(prod)
    got = fhe.decode(fhe.decrypt(switched, sk))
    assert list(got[:2]) == [15, 60]


def test_add_rejects_scale_mismatch(fhe, keys):
    pk, _, _ = keys
    ct = fhe.encrypt(fhe.encode([1]), pk)
    ct1 = fhe.mod_switch_to_next(ct)
    ct_other = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode([2]), pk))
    # same level+scale works
    fhe.add(ct1, ct_other)
    # raw vs switched must fail loudly (level check fires first)
    with pytest.raises(ValueError):
        bgv.add(fhe.ctx, ct, ct1)


def test_rotations(fhe, keys):
    pk, sk, _ = keys
    gal = fhe.galoiskey_gen(sk)
    half = PARAMS.slot_count
    vals = list(range(1, half + 1)) + list(range(1001, 1001 + half))
    ct = fhe.encrypt(fhe.encode(vals), pk)
    got = fhe.decode(fhe.decrypt(fhe.rotate_rows(ct, 1, gal), sk))
    row0, row1 = vals[:half], vals[half:]
    assert list(got[:half]) == row0[1:] + row0[:1]
    assert list(got[half:]) == row1[1:] + row1[:1]
    gotc = fhe.decode(fhe.decrypt(fhe.rotate_columns(ct, gal), sk))
    assert list(gotc[:half]) == row1


def test_noise_budget_and_bootstrap(fhe, keys):
    pk, sk, rlk = keys
    ct = fhe.encrypt(fhe.encode([11, 22]), pk)
    fresh = fhe.estimate_noise_budget(ct, sk)
    assert fresh > 40
    ct2 = fhe.multiply(ct, ct, rlk)
    after = fhe.estimate_noise_budget(ct2, sk)
    assert 0 < after < fresh
    ct_fresh = fhe.bootstrap(ct2, sk, pk)
    assert fhe.estimate_noise_budget(ct_fresh, sk) > after
    assert list(fhe.decode(fhe.decrypt(ct_fresh, sk))[:2]) == [121, 484]
