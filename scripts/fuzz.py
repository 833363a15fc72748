#!/usr/bin/env python3
"""Randomized-circuit fuzzer: long-running correctness hunt.

Generates random homomorphic circuits (add/sub/mul/plain ops/rotations/
mod-switch) over random parameter sets and both schemes, tracking a plaintext
slot model; any mismatch (with positive measured noise budget) is a
correctness bug.  The pytest suite runs a handful of fixed seeds
(tests/test_property_chains.py); this script runs until interrupted or
--iterations, printing one line per circuit.

    JAX_PLATFORMS=cpu python scripts/fuzz.py --iterations 50
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fhe_jax.utils import compile_cache  # noqa: E402


def run_circuit(seed: int) -> tuple[bool, str]:
    import jax
    from fhe_jax import FHE
    from fhe_jax.params import SecurityParams, make_scheme_params

    rng = np.random.default_rng(seed)
    scheme = rng.choice(["bfv", "bgv"])
    n = int(rng.choice([128, 256, 512]))
    log_q = int(rng.choice([120, 150, 180]))
    hw = int(rng.choice([8, 16, 32]))
    # mixed plaintext moduli (all prime, = 1 mod 2n for n <= 8192):
    # 65537 Fermat fast path, 114689 = 7*2^14+1 and 786433 = 3*2^18+1 generic
    t_choice = int(rng.choice([65537, 65537, 114689, 786433]))
    # r5: randomly exercise the grouped gadget (ks_omega=2)
    omega = int(rng.choice([1, 1, 2]))
    params = make_scheme_params(
        SecurityParams(poly_degree=n, log_q=log_q, hamming_weight=hw,
                       plain_modulus=t_choice, ks_omega=omega))
    t = params.t
    half = params.slot_count
    fhe = FHE(params, seed=seed, scheme=str(scheme))
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gal = fhe.galoiskey_gen(sk)

    def rot_model(vec, steps):
        r0, r1 = vec[:half], vec[half:]
        return np.concatenate([np.roll(r0, -steps), np.roll(r1, -steps)])

    def fresh():
        v = rng.integers(0, t, size=2 * half).astype(np.int64)
        return fhe.encrypt(fhe.encode(v), pk), v

    ct, model = fresh()
    level_budget = params.k - 1
    mults = 0
    # each multiply consumes ~log2(n) + log2(t) + slack bits of budget
    max_mults = max(1, (log_q - 60) // (26 + t.bit_length()))
    ops_trace = []
    n_ops = int(rng.integers(4, 12))
    for _ in range(n_ops):
        op = rng.choice(
            ["add", "sub", "mul", "add_plain", "sub_plain", "mul_plain",
             "rot_rows", "rot_cols", "mod_switch", "toggle_domain"])
        try:
            if op in ("add", "sub"):
                other, ov = fresh()
                other = fhe.mod_switch_to_level(other, ct.level)
                if scheme == "bgv" and other.scale_t != ct.scale_t:
                    continue
                if ct.is_ntt_form:          # r5 residency: match domains
                    other = fhe.to_ntt(other)
                ct = fhe.add(ct, other) if op == "add" else fhe.sub(ct, other)
                model = (model + ov) % t if op == "add" else (model - ov) % t
            elif op == "mul":
                if mults >= max_mults:
                    continue
                other, ov = fresh()
                other = fhe.mod_switch_to_level(other, ct.level)
                if scheme == "bgv" and other.scale_t != ct.scale_t:
                    continue
                ct = fhe.multiply(ct, other, rlk)
                model = (model * ov) % t
                mults += 1
            elif op in ("add_plain", "sub_plain", "mul_plain"):
                pv = rng.integers(0, 30 if op == "mul_plain" else t,
                                  size=2 * half).astype(np.int64)
                pt = fhe.encode(pv)
                if op == "add_plain":
                    ct = fhe.add_plain(ct, pt)
                    model = (model + pv) % t
                elif op == "sub_plain":
                    ct = fhe.sub_plain(ct, pt)
                    model = (model - pv) % t
                else:
                    # r5: randomly exercise the cached NTT-form operand
                    ct = fhe.multiply_plain(
                        ct, pt, cache_operand=bool(rng.integers(0, 2)))
                    model = (model * pv) % t
                    mults += 0  # plain mul grows noise but no level cost
            elif op == "rot_rows":
                steps = int(rng.integers(1, half))
                if rng.integers(0, 2) and steps in (1, 2, 4):
                    # hoisted path (needs a direct key: default keygen
                    # covers power-of-two steps)
                    ct = fhe.rotate_rows_hoisted(ct, [steps], gal)[0]
                else:
                    ct = fhe.rotate_rows(ct, steps, gal)
                model = rot_model(model, steps)
            elif op == "rot_cols":
                ct = fhe.rotate_columns(ct, gal)
                model = np.concatenate([model[half:], model[:half]])
            elif op == "mod_switch":
                if ct.level >= level_budget:
                    continue
                ct = fhe.mod_switch_to_next(ct)
            elif op == "toggle_domain":
                # r5 NTT-form residency: plain ops run domain-resident;
                # key-switch ops and decrypt convert at their boundary
                ct = fhe.to_coeff(ct) if ct.is_ntt_form else fhe.to_ntt(ct)
            ops_trace.append(str(op))
        except ValueError:
            continue  # scale/level mismatch guards firing is fine

    # True-noise check against the MODEL plaintext (library API, round-1
    # review item 8): exact_noise_budget goes negative past exhaustion, so
    # there is no post-exhaustion blind spot to work around.
    budget = fhe.exact_noise_budget(ct, sk, fhe.encode(model))
    tracked = float(ct.noise_budget)
    desc = (f"seed={seed} {scheme} n={n} logq={log_q} t={t} ops={ops_trace} "
            f"budget={budget:.2f} tracked={tracked:.2f}")
    if budget <= 0.0 or (budget < 1.0 and tracked <= 0.0):
        # genuinely exhausted; correctness is undefined, but the tracked
        # budget must have warned (pinned at its 0 floor).  The second
        # clause is the measurement-aliasing window (exact_noise_budget
        # docstring, surfaced by seed 4004): a true noise past q/2 wraps
        # mod q and can read back as a small positive budget — trust the
        # sub-1-bit reading only when the tracked budget is still positive.
        if tracked > 4.0:
            return False, desc + " EXHAUSTED but tracked budget still high"
        return True, desc + " [noise exhausted — flagged by library]"
    got = fhe.decode(fhe.decrypt(ct, sk)).astype(np.int64)
    if not np.array_equal(got, model):
        bad = np.nonzero(got != model)[0][:5]
        return False, desc + f" MISMATCH at slots {bad.tolist()}"
    return True, desc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--start-seed", type=int, default=1000)
    args = ap.parse_args()
    compile_cache.configure()

    failures = 0
    t0 = time.time()
    for i in range(args.iterations):
        seed = args.start_seed + i
        ok, desc = run_circuit(seed)
        print(("PASS " if ok else "FAIL ") + desc, flush=True)
        failures += not ok
    print(f"\n{args.iterations - failures}/{args.iterations} circuits OK "
          f"in {time.time() - t0:.0f}s")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
