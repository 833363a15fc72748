#!/usr/bin/env python3
"""BGV Scheme Example — the second scheme of the reference's "BGV/BFV"
declaration, with the BGV-specific workflow: multiply (no rescale) followed
by modulus switching for noise management.

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
    print(f"  Result:   {got}\n  Expected: {expected}")
    print(f"  {'OK:' if ok else 'FAIL:'} {label}\n")
    return ok


def main() -> int:
    print("=== FHE BGV Operations Example ===\n")

    degree = int(os.environ.get("FHE_EXAMPLE_POLY_DEGREE", "4096"))
    fhe = FHE(poly_degree=degree, log_q=150, seed=17, scheme="bgv")
    print(f"Scheme: BGV  (phase = m + t*e; multiply without rescale)")
    print(f"Polynomial degree: {fhe.params.n}, RNS primes: {fhe.params.k}\n")

    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    ok = True

    data_a = [10, 20, 30, 40]
    data_b = [5, 15, 25, 35]
    ct_a = fhe.encrypt(fhe.encode(data_a), pk)
    ct_b = fhe.encrypt(fhe.encode(data_b), pk)

    print("Computing: ct_a + ct_b")
    ok &= check("BGV addition", fhe.decode(fhe.decrypt(fhe.add(ct_a, ct_b), sk)),
                [15, 35, 55, 75])

    print("Computing: ct_a * ct_b (plain tensor product + relinearize)")
    prod = fhe.multiply(ct_a, ct_b, rlk)
    ok &= check("BGV multiplication", fhe.decode(fhe.decrypt(prod, sk)),
                [50, 300, 750, 1400])

    print("Noise management: modulus switch after multiply")
    print(f"  budget before switch: {fhe.estimate_noise_budget(prod, sk):.1f} bits "
          f"of log2(q)={fhe.params.q.bit_length()}")
    switched = fhe.mod_switch_to_next(prod)
    print(f"  level {switched.level}, scale_t correction = {switched.scale_t}")
    print(f"  budget after switch (smaller q): "
          f"{fhe.estimate_noise_budget(switched, sk):.1f} bits")
    ok &= check("decrypt after mod switch",
                fhe.decode(fhe.decrypt(switched, sk)), [50, 300, 750, 1400])

    print("Depth-2: (a*b) * a at level 1")
    a1 = fhe.mod_switch_to_next(ct_a)
    deep = fhe.multiply(switched, a1, rlk)
    ok &= check("depth-2 product", fhe.decode(fhe.decrypt(deep, sk)),
                [500, 6000, 22500, 56000])

    print("=== Example Complete ===")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
