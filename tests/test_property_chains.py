"""Randomized homomorphic-circuit property tests: a random sequence of
add / sub / multiply / plain ops / rotations applied under encryption must
track the same sequence applied to the plaintext slot vectors, for both
schemes.  This is the strongest end-to-end correctness artifact the test
suite has — any kernel/scheme regression shows up as a slot mismatch."""

import numpy as np
import pytest

from fhe_jax import FHE
from fhe_jax.params import SecurityParams, make_scheme_params

PARAMS = make_scheme_params(
    SecurityParams(poly_degree=256, log_q=150, hamming_weight=32))
T = PARAMS.t
HALF = PARAMS.slot_count


def _rot_rows(vec, steps):
    """Plaintext model of rotate_rows on the 2 x (n/2) slot matrix."""
    r0, r1 = vec[:HALF], vec[HALF:]
    return np.concatenate([np.roll(r0, -steps), np.roll(r1, -steps)])


@pytest.mark.parametrize("scheme,seed", [
    ("bfv", 101), ("bfv", 202), ("bgv", 303), ("bgv", 404),
])
def test_random_circuit_tracks_plaintext_model(scheme, seed):
    rng = np.random.default_rng(seed)
    fhe = FHE(PARAMS, seed=seed, scheme=scheme)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gal = fhe.galoiskey_gen(sk)

    def fresh():
        vals = rng.integers(0, 100, size=2 * HALF).astype(np.int64)
        return fhe.encrypt(fhe.encode(vals), pk), vals

    ct, model = fresh()
    mults_done = 0
    ops = rng.choice(
        ["add", "sub", "mul", "add_plain", "mul_plain", "rot"], size=8)
    trace = []
    for op in ops:
        if op == "add":
            other, ovals = fresh()
            ct = fhe.add(ct, other)
            model = (model + ovals) % T
        elif op == "sub":
            other, ovals = fresh()
            ct = fhe.sub(ct, other)
            model = (model - ovals) % T
        elif op == "mul":
            if mults_done >= 1:   # depth budget at log q = 150
                continue
            other, ovals = fresh()
            ct = fhe.multiply(ct, other, rlk)
            model = (model * ovals) % T
            mults_done += 1
        elif op == "add_plain":
            pvals = rng.integers(0, 50, size=2 * HALF).astype(np.int64)
            ct = fhe.add_plain(ct, fhe.encode(pvals))
            model = (model + pvals) % T
        elif op == "mul_plain":
            pvals = rng.integers(1, 5, size=2 * HALF).astype(np.int64)
            ct = fhe.multiply_plain(ct, fhe.encode(pvals))
            model = (model * pvals) % T
        elif op == "rot":
            steps = int(rng.integers(1, 4))
            ct = fhe.rotate_rows(ct, steps, gal)
            model = _rot_rows(model, steps)
        trace.append(op)

    budget = fhe.estimate_noise_budget(ct, sk)
    assert budget > 0, f"noise exhausted after {trace}"
    got = fhe.decode(fhe.decrypt(ct, sk)).astype(np.int64)
    np.testing.assert_array_equal(got, model, err_msg=f"circuit {trace}")


@pytest.mark.parametrize("scheme", ["bfv", "bgv"])
def test_rotate_then_accumulate_inner_product(scheme):
    """The canonical FHE kernel: encrypted inner product via rotate-and-add
    (log-depth slot reduction) against the plaintext dot product."""
    rng = np.random.default_rng(7)
    fhe = FHE(PARAMS, seed=7, scheme=scheme)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gal = fhe.galoiskey_gen(sk)

    x = rng.integers(0, 20, size=HALF).astype(np.int64)
    y = rng.integers(0, 20, size=HALF).astype(np.int64)
    ct = fhe.multiply(fhe.encrypt(fhe.encode(x), pk),
                      fhe.encrypt(fhe.encode(y), pk), rlk)
    step = 1
    while step < HALF:
        ct = fhe.add(ct, fhe.rotate_rows(ct, step, gal))
        step *= 2
    got = int(fhe.decode(fhe.decrypt(ct, sk))[0])
    assert got == int(np.dot(x, y)) % T


def test_bfv_chain_with_mod_switch():
    """Chains that mod-switch mid-circuit (BFV) keep tracking the model:
    switch, then keep adding/rotating/multiplying at the lower level."""
    rng = np.random.default_rng(55)
    fhe = FHE(PARAMS, seed=55)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gal = fhe.galoiskey_gen(sk)

    v1 = rng.integers(0, 50, size=2 * HALF).astype(np.int64)
    v2 = rng.integers(0, 50, size=2 * HALF).astype(np.int64)
    ct = fhe.multiply(fhe.encrypt(fhe.encode(v1), pk),
                      fhe.encrypt(fhe.encode(v2), pk), rlk)
    model = (v1 * v2) % T

    ct = fhe.mod_switch_to_next(ct)
    ct = fhe.rotate_rows(ct, 2, gal)            # leveled rotation
    model = _rot_rows(model, 2)

    other = fhe.mod_switch_to_next(fhe.encrypt(fhe.encode(v1), pk))
    ct = fhe.add(ct, other)
    model = (model + v1) % T

    ct = fhe.multiply(ct, other, rlk)           # leveled multiply
    model = (model * v1) % T

    got = fhe.decode(fhe.decrypt(ct, sk)).astype(np.int64)
    np.testing.assert_array_equal(got, model)
