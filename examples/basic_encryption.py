#!/usr/bin/env python3
"""Basic Encryption Example — keygen, encode, encrypt, decrypt, decode.

Mirrors the reference workflow ``examples/basic_encryption.cu`` (same
parameters lambda=128, N=4096, log q=120; same data {42, 100, 255, 1337};
same verification contract: exit 0 iff decrypt(encrypt(m)) == m).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from fhe_jax import FHE


def main() -> int:
    print("=== FHE Basic Encryption Example ===\n")

    # Step 1: security parameters (reference examples/basic_encryption.cu:21-33)
    print("1. Setting up parameters...")
    degree = int(os.environ.get("FHE_EXAMPLE_POLY_DEGREE", "4096"))
    fhe = FHE(lambda_=128, poly_degree=degree, log_q=120, sigma=3.2,
              hamming_weight=64, seed=2024)
    print(f"   Security level: {fhe.params.security.lambda_} bits")
    print(f"   Polynomial degree: {fhe.params.n}")
    print(f"   RNS primes: {fhe.params.k} x ~30 bits\n")

    # Step 2: keys
    print("2. Generating keys...")
    pk, sk = fhe.keygen()
    print("   Keys generated successfully!\n")

    # Step 3: data
    data = [42, 100, 255, 1337]
    print(f"3. Preparing plaintext data...\n   Original data: {data}\n")

    # Step 4: encode
    print("4. Encoding plaintext...")
    pt = fhe.encode(data)
    print("   Data encoded into polynomial (SIMD slots)\n")

    # Step 5: encrypt
    print("5. Encrypting...")
    ct = fhe.encrypt(pt, pk)
    budget = fhe.estimate_noise_budget(ct, sk)
    print("   Data encrypted successfully!")
    print(f"   Ciphertext has {ct.num_components} components")
    print(f"   Initial noise budget: {budget:.1f} bits\n")

    # Step 6: decrypt
    print("6. Decrypting...")
    pt_result = fhe.decrypt(ct, sk)
    print("   Data decrypted successfully!\n")

    # Step 7: decode
    print("7. Decoding result...")
    decrypted = fhe.decode(pt_result)[: len(data)]
    print(f"   Decrypted data: {list(map(int, decrypted))}\n")

    # Step 8: verify
    print("8. Verifying correctness...")
    if np.array_equal(decrypted, np.array(data, dtype=decrypted.dtype)):
        print("   OK: all values match — encryption/decryption successful!\n")
    else:
        print(f"   FAIL: expected {data}, got {list(map(int, decrypted))}\n")
        return 1

    print("=== Example Complete ===")
    return 0


if __name__ == "__main__":
    sys.exit(main())
