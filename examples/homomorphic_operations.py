#!/usr/bin/env python3
"""Homomorphic Operations Example — add, multiply, chained, plaintext ops.

Mirrors the reference workflow ``examples/homomorphic_operations.cu`` with the
same data and golden expected vectors:
  * add:        {10,20,30,40} + {5,15,25,35}        -> {15,35,55,75}   (:92)
  * multiply:   {3,4,5,6} * {2,5,10,3}              -> {6,20,50,18}    (:148)
  * chained:    ({10..40}+{5..35}) * {3,4,5,6}      -> {45,140,275,450}(:194)
  * add_plain:  {10,20,30,40} + 2                   -> {12,22,32,42}   (:228)
  * mul_plain:  {10,20,30,40} * 2                   -> {20,40,60,80}   (:242)
Exit 0 iff every vector matches.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from fhe_jax import FHE


def check(label, got, expected):
    got = list(map(int, got[: len(expected)]))
    ok = got == expected
    print(f"  Result:   {got}")
    print(f"  Expected: {expected}")
    print(f"  {'OK:' if ok else 'FAIL:'} {label} "
          f"{'correct!' if ok else 'mismatch!'}\n")
    return ok


def main() -> int:
    print("=== FHE Homomorphic Operations Example ===\n")

    print("Setting up FHE context (lambda=128, N=4096, log q=120)...")
    degree = int(os.environ.get("FHE_EXAMPLE_POLY_DEGREE", "4096"))
    fhe = FHE(poly_degree=degree, log_q=120, seed=7)

    print("Generating keys (public, secret, relinearization)...\n")
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)

    ok = True

    # -- Part 1: homomorphic addition ------------------------------------
    print("=" * 40 + "\nPART 1: Homomorphic Addition\n" + "=" * 40)
    data_a = [10, 20, 30, 40]
    data_b = [5, 15, 25, 35]
    print(f"  Data A: {data_a}\n  Data B: {data_b}")
    ct_a = fhe.encrypt(fhe.encode(data_a), pk)
    ct_b = fhe.encrypt(fhe.encode(data_b), pk)
    print(f"  ct_a noise budget: {fhe.estimate_noise_budget(ct_a, sk):.1f} bits")
    print("Computing: ct_sum = ct_a + ct_b (encrypted)")
    ct_sum = fhe.add(ct_a, ct_b)
    ok &= check("Addition", fhe.decode(fhe.decrypt(ct_sum, sk)), [15, 35, 55, 75])

    # -- Part 2: homomorphic multiplication ------------------------------
    print("=" * 40 + "\nPART 2: Homomorphic Multiplication\n" + "=" * 40)
    data_x = [3, 4, 5, 6]
    data_y = [2, 5, 10, 3]
    print(f"  Data X: {data_x}\n  Data Y: {data_y}")
    ct_x = fhe.encrypt(fhe.encode(data_x), pk)
    ct_y = fhe.encrypt(fhe.encode(data_y), pk)
    print("Computing: ct_product = ct_x * ct_y (encrypted, with relinearization)")
    ct_product = fhe.multiply(ct_x, ct_y, rlk)
    print(f"  ct_product has {ct_product.num_components} components "
          f"(after relinearization)")
    print(f"  ct_product noise budget: "
          f"{fhe.estimate_noise_budget(ct_product, sk):.1f} bits")
    ok &= check("Multiplication", fhe.decode(fhe.decrypt(ct_product, sk)),
                [6, 20, 50, 18])

    # -- Part 3: chained operations --------------------------------------
    print("=" * 40 + "\nPART 3: Chained Operations\n" + "=" * 40)
    print("Computing: (ct_a + ct_b) * ct_x")
    ct_chain = fhe.multiply(fhe.add(ct_a, ct_b), ct_x, rlk)
    # (10+5)*3, (20+15)*4, (30+25)*5, (40+35)*6
    ok &= check("Chained ops", fhe.decode(fhe.decrypt(ct_chain, sk)),
                [45, 140, 275, 450])

    # -- Part 4: plaintext operands --------------------------------------
    print("=" * 40 + "\nPART 4: Ciphertext-Plaintext Operations\n" + "=" * 40)
    pt_two = fhe.encode([2] * fhe.slot_count)
    print("Computing: ct_a + plaintext(2)")
    ok &= check("Add plain", fhe.decode(fhe.decrypt(fhe.add_plain(ct_a, pt_two), sk)),
                [12, 22, 32, 42])
    print("Computing: ct_a * plaintext(2)")
    ok &= check("Multiply plain",
                fhe.decode(fhe.decrypt(fhe.multiply_plain(ct_a, pt_two), sk)),
                [20, 40, 60, 80])

    print("=== Example Complete ===")
    if not ok:
        return 1
    fhe.monitor.print_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
