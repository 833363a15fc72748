#!/usr/bin/env python3
"""Bootstrapping Example — the declared pipeline with real math.

Demonstrates the reference's declared bootstrapping chain
(``include/fhe.cuh:138-140``; README "Bootstrapping Implementation"):

    extract_lsb -> blind_rotate -> modulus_raise -> key_switch

on an encrypted bit: a noisy ciphertext is refreshed WITHOUT decrypting —
the plaintext travels through an LWE sample and an encrypted accumulator
rotation (CGGI-style, 2n RGSW external products).  Exit 0 iff the
refreshed ciphertext decrypts to the original bit for both bit values.

Small parameters by default (the rotation costs 2n external products);
override with FHE_EXAMPLE_POLY_DEGREE.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax.numpy as jnp

from fhe_jax import FHE
from fhe_jax.scheme.types import Plaintext


def main() -> int:
    print("=== FHE Bootstrapping Example ===\n")

    degree = int(os.environ.get("FHE_EXAMPLE_POLY_DEGREE", "256"))
    fhe = FHE(lambda_=0, poly_degree=degree, log_q=120, hamming_weight=16,
              seed=7)
    print(f"1. Parameters: n={fhe.params.n}, k={fhe.params.k} RNS primes\n")

    print("2. Generating keys (incl. the RGSW bootstrap key)...")
    pk, sk = fhe.keygen()
    bsk = fhe.make_bootstrap_key(sk)
    print("   done\n")

    ok = True
    for bit in (0, 1):
        data = np.zeros(fhe.params.n, dtype=np.uint32)
        data[0] = bit
        ct = fhe.encrypt(Plaintext(data=jnp.asarray(data)), pk)
        print(f"3. Encrypted bit {bit} "
              f"(budget {float(ct.noise_budget):.1f} bits)")

        fresh = fhe.bootstrap_binary(ct, sk, bsk)
        got = int(np.asarray(fhe.decrypt(fresh, sk).data)[0])
        status = "OK" if got == bit else "MISMATCH"
        print(f"   bootstrap -> decrypts to {got}  [{status}]  "
              f"(budget {float(fresh.noise_budget):.1f} bits)\n")
        ok &= got == bit

    # PROGRAMMABLE bootstrap: an arbitrary lookup table is evaluated
    # DURING the refresh — here squaring mod 5 on a 2-bit payload
    # (bootstrap_lut; the binary refresh above is its lut=[0,1] case)
    lut = [(m * m) % 5 for m in range(4)]
    print(f"4. Programmable bootstrap: lut = {lut} (m -> m^2 mod 5)")
    for m in range(4):
        data = np.zeros(fhe.params.n, dtype=np.uint32)
        data[0] = m
        ct = fhe.encrypt(Plaintext(data=jnp.asarray(data)), pk)
        out = fhe.bootstrap_lut(ct, lut, sk, bsk)
        got = int(np.asarray(fhe.decrypt(out, sk).data)[0])
        status = "OK" if got == lut[m] else "MISMATCH"
        print(f"   lut[{m}] -> {got}  [{status}]")
        ok &= got == lut[m]
    print()

    print("=== " + ("Example completed successfully!"
                    if ok else "EXAMPLE FAILED") + " ===")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
