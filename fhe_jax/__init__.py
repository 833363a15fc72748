"""fhe_jax — a BFV/BGV homomorphic-encryption primitive library in JAX.

A JAX implementation with the capabilities of the reference CUDA library
``codebasecomprehension987/gpu-homomorphic-encryption``: RNS modular
arithmetic (30-bit primes in uint32 lanes replace the reference's 256-bit
limbs + PTX carry chains), negacyclic NTT, RNS/CRT, and the full BFV and BGV
schemes (keygen, encode/encrypt, add/sub/plain ops, multiply + relinearize,
Galois rotations, modulus switching, bootstrapping), sharded over device
meshes with jax collectives.
"""

from .params import SecurityParams, SchemeParams, make_scheme_params, default_params
from .api import FHE

__all__ = [
    "SecurityParams",
    "SchemeParams",
    "make_scheme_params",
    "default_params",
    "FHE",
]

__version__ = "0.1.0"
