"""The reference's throughput configuration: log q = 218 -> k = 8 RNS primes
(tests/test_fhe.cu:275-318 benchmarks N=8192, log q=218).  Pins the batched
key-switch inner product (bfv._keyswitch_inner) at a digit count where the
round-1 serial loop was the critical path, plus a leveled chain across many
levels.  n is kept small for CPU CI; bench.py runs the full-size config.
"""

import numpy as np

from fhe_jax import FHE
from fhe_jax.params import SecurityParams, make_scheme_params

PARAMS = make_scheme_params(SecurityParams(
    poly_degree=256, log_q=218, lambda_=0, hamming_weight=16))


def test_k8_multiply_relin():
    assert PARAMS.k == 8
    fhe = FHE(PARAMS, seed=0)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a = fhe.encrypt(fhe.encode([10, 20, 30, 40]), pk)
    b = fhe.encrypt(fhe.encode([5, 15, 25, 35]), pk)
    got = fhe.decode(fhe.decrypt(fhe.multiply(a, b, rlk), sk))
    assert list(got[:4]) == [50, 300, 750, 1400]


def test_k8_deep_leveled_chain():
    """Multiply at levels 0..3 with on-the-fly key down-switching."""
    fhe = FHE(PARAMS, seed=1)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    ct = fhe.encrypt(fhe.encode([2, 3]), pk)
    model = np.array([2, 3], dtype=object)
    for level in range(4):
        other = fhe.encrypt(fhe.encode([3, 5]), pk)
        other = fhe.mod_switch_to_level(other, ct.level)
        ct = fhe.multiply(ct, other, rlk)
        model = model * np.array([3, 5], dtype=object) % PARAMS.t
        ct = fhe.mod_switch_to_next(ct)
    got = fhe.decode(fhe.decrypt(ct, sk))
    assert list(got[:2]) == [int(v) for v in model]
    assert ct.level == 4


def test_k8_bgv_multiply():
    fhe = FHE(PARAMS, seed=2, scheme="bgv")
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    a = fhe.encrypt(fhe.encode([7, 11]), pk)
    got = fhe.decode(fhe.decrypt(fhe.multiply(a, a, rlk), sk))
    assert list(got[:2]) == [49, 121]
