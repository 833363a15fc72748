"""Key / ciphertext / plaintext pytrees.

Mirrors the reference structs (``include/fhe.cuh:42-75``) as functional
pytrees of uint32 residue tensors instead of vectors of device pointers:

  * residue layout is prime-major ``[k, ..., n]`` so the leading axis shards
    across chips (SURVEY.md §2 parallelism table),
  * ``level`` / ``is_ntt_form`` are static metadata (part of the trace),
  * ``noise_budget`` and BGV's ``scale_t`` are TRACED pytree leaves (see
    the field comments below) — do not branch on them inside jit.  The
    reference's analog is a host float (``include/fhe.cuh:67``).
"""

from __future__ import annotations

import jax

from ..utils import struct


@struct.dataclass
class Plaintext:
    """Polynomial mod t (reference ``Plaintext``, ``include/fhe.cuh:72-75``)."""

    data: jax.Array  # [n] uint32, coefficients mod t
    is_ntt_form: bool = struct.field(pytree_node=False, default=False)


@struct.dataclass
class Ciphertext:
    """(c0, c1, ...) residue stack (reference ``include/fhe.cuh:64-69``)."""

    data: jax.Array  # [k, num_components, n] uint32
    level: int = struct.field(pytree_node=False, default=0)
    is_ntt_form: bool = struct.field(pytree_node=False, default=False)
    # Tracked noise budget in bits (scheme/noise.py variance model).  A
    # pytree LEAF, not static metadata: as a static field every distinct
    # float would retrace each jitted op it flows through (the same
    # compile-cache hazard the round-1 advisor flagged for scale_t).  The
    # model's per-op updates are a handful of scalar jnp ops.
    noise_budget: "float | jax.Array" = 0.0
    # BGV correction factor (SEAL-style): each mod-switch divides the
    # underlying plaintext by q_last mod t; decrypt multiplies back by
    # scale_t = prod(dropped primes) mod t, kept reduced < t.  Always 1 for
    # BFV.  A pytree LEAF (traced uint32 scalar under jit), deliberately not
    # static: a static field would recompile every jitted op for each
    # distinct accumulated correction (round-1 advisor finding) — deep BGV
    # circuits produce unboundedly many values.  Host code may still carry
    # it as a plain int; ops accept either.
    scale_t: "int | jax.Array" = 1

    @property
    def num_components(self) -> int:
        return self.data.shape[1]


@struct.dataclass
class PublicKey:
    """(b, a) = (e - a*s, a), stored in NTT form (``include/fhe.cuh:42-45``)."""

    data: jax.Array  # [k, 2, n] uint32, NTT domain


@struct.dataclass
class SecretKey:
    """Ternary secret, stored in NTT form per prime (``include/fhe.cuh:48-50``)."""

    data: jax.Array  # [k, 1, n] uint32, NTT domain


@struct.dataclass
class RelinKeys:
    """RNS-digit key-switching keys (``include/fhe.cuh:53-56``); digit j is a
    (b, a) pair encrypting (q/q_j)*s^2."""

    data: jax.Array  # [num_digits=k, k, 2, n] uint32, NTT domain


@struct.dataclass
class GaloisKeys:
    """Key-switching keys per Galois element (``include/fhe.cuh:59-61``)."""

    data: dict[int, jax.Array]  # g -> [k, k, 2, n], NTT domain

    def elements(self):
        return tuple(sorted(self.data.keys()))
