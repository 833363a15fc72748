"""Grouped-gadget key switching (SecurityParams.ks_omega — SEAL's
decomposition-base idea on the RNS basis; the k=8 relinearization lever).

omega=2 halves the gadget digit count: half the digit NTTs and key inner
products per key switch, at ~PRIME_BITS extra bits of key-switch noise.
The grouped digit is recovered from the STANDARD per-prime digits by CRT
interpolation with an exactly-absorbed overflow (context.ks_group_conv_tables
docstring), so correctness holds with no new number theory on device.
"""

import numpy as np
import pytest

from fhe_jax import FHE
from fhe_jax.params import SecurityParams, make_scheme_params


def _mk(scheme="bfv", log_q=120, omega=2, n=256, hw=16, seed=7):
    params = make_scheme_params(SecurityParams(
        poly_degree=n, log_q=log_q, lambda_=0, hamming_weight=hw,
        ks_omega=omega))
    return FHE(params, seed=seed, scheme=scheme)


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_multiply_relin_omega2(scheme):
    fhe = _mk(scheme)
    assert fhe.params.k == 4
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    assert rlk.data.shape[0] == 2, "omega=2 at k=4 must give 2 digit groups"
    a = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    b = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
    got = fhe.decode(fhe.decrypt(fhe.multiply(a, b, rlk), sk))
    assert list(got[:4]) == [15, 60, 135, 240], got[:4]


def test_multiply_omega2_odd_k():
    """k=5 with omega=2: the short last group (kd=3, pad path)."""
    fhe = _mk(log_q=150)
    assert fhe.params.k == 5
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    assert rlk.data.shape[0] == 3
    a = fhe.encrypt(fhe.encode([7, 8]), pk)
    b = fhe.encrypt(fhe.encode([2, 3]), pk)
    got = fhe.decode(fhe.decrypt(fhe.multiply(a, b, rlk), sk))
    assert list(got[:2]) == [14, 24], got[:2]


def test_rotations_omega2():
    fhe = _mk()
    pk, sk = fhe.keygen()
    gk = fhe.galoiskey_gen(sk)
    n, t = fhe.params.n, fhe.params.t
    vals = np.arange(n) % t
    ct = fhe.encrypt(fhe.encode(vals), pk)
    rot = fhe.rotate_rows(ct, 3, gk)
    half = n // 2
    model = np.concatenate(
        [np.roll(vals[:half], -3), np.roll(vals[half:], -3)])
    got = fhe.decode(fhe.decrypt(rot, sk)).astype(np.int64)
    assert np.array_equal(got, model)
    # hoisted path shares one GROUPED decomposition across elements
    outs = fhe.rotate_rows_hoisted(ct, [1, 2], gk)
    for s, o in zip([1, 2], outs):
        model = np.concatenate(
            [np.roll(vals[:half], -s), np.roll(vals[half:], -s)])
        got = fhe.decode(fhe.decrypt(o, sk)).astype(np.int64)
        assert np.array_equal(got, model), s


def test_leveled_omega2_alignment():
    """Keys switch down only through WHOLE gadget groups: k=6, omega=2 —
    level 2 (kl=4, kd=2) works, level 1 (kl=5) raises.  (A level where only
    ONE group survives is mathematically useless — the digit spans the
    whole modulus, so key-switch noise >= q_L; keep kd_l >= 2.)"""
    from fhe_jax.scheme import bfv
    fhe = _mk(log_q=180)
    assert fhe.params.k == 6
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a = fhe.encrypt(fhe.encode([5, 6]), pk)
    b = fhe.encrypt(fhe.encode([2, 4]), pk)
    a2 = fhe.mod_switch_to_level(a, 2)
    b2 = fhe.mod_switch_to_level(b, 2)
    got = fhe.decode(fhe.decrypt(fhe.multiply(a2, b2, rlk), sk))
    assert list(got[:2]) == [10, 24], got[:2]
    with pytest.raises(ValueError, match="ks_omega"):
        bfv.switch_relin_keys(fhe.ctx, rlk, level=1)


def test_noise_budget_omega2_tracks_measurement():
    """The omega-aware keyswitch_add must keep tracked-vs-exact within the
    suite's tolerance after a multiply+rotate chain."""
    fhe = _mk(log_q=180, n=1024, hw=64, seed=11)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk, elements=[pow(3, 1, 2 * fhe.params.n)])
    t = fhe.params.t
    rng = np.random.default_rng(0)
    va = rng.integers(0, t, fhe.params.n)
    vb = rng.integers(0, t, fhe.params.n)
    ct = fhe.multiply(fhe.encrypt(fhe.encode(va), pk),
                      fhe.encrypt(fhe.encode(vb), pk), rlk)
    ct = fhe.rotate_rows(ct, 1, gk)
    half = fhe.params.n // 2
    mv = va * vb % t
    model = np.concatenate([np.roll(mv[:half], -1), np.roll(mv[half:], -1)])
    exact = fhe.exact_noise_budget(ct, sk, fhe.encode(model))
    assert abs(float(ct.noise_budget) - exact) <= 4.0, (
        f"tracked {float(ct.noise_budget):.2f} vs exact {exact:.2f}")
    got = fhe.decode(fhe.decrypt(ct, sk)).astype(np.int64)
    assert np.array_equal(got, model)
