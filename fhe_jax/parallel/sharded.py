"""User-facing sharded-execution helpers.

The scheme functions (scheme/bfv.py, scheme/bgv.py) are pure jitted functions
over ``[k, ..., n]`` residue pytrees, so multi-chip execution is entirely a
matter of placing the arrays with the right shardings and letting XLA insert
the collectives (the "pick a mesh, annotate shardings" recipe).  This module
packages the two production layouts:

* **rns** — the RNS prime axis across chips (the reference's prime-per-GPU
  design, ``docs/ARCHITECTURE.md:499-511``): per-prime NTTs run with zero
  communication; CRT/base-conversion steps become cross-chip reductions.
* **dp** — batch data-parallelism: independent ciphertexts per chip.

Example::

    mesh = make_mesh({"rns": 8})
    sfhe = ShardedFHE(fhe, mesh)
    ct1, ct2 = sfhe.shard(ct1), sfhe.shard(ct2)
    out = sfhe.multiply(ct1, ct2, rlk)          # runs sharded
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..scheme.types import (Ciphertext, GaloisKeys, PublicKey, RelinKeys,
                            SecretKey)
from .mesh import make_mesh, rns_sharding


class ShardedFHE:
    """Wraps an ``fhe_jax.FHE`` instance with a mesh; scheme calls run with
    the prime axis sharded (axis name ``rns``).

    ``multiply`` routes through the EXPLICIT shard_map BEHZ path
    (parallel/shard_scheme.py) whenever the mesh has the rns axis and the
    prime count divides it, so every collective is a named one; the
    auto-partitioned layout is the fallback."""

    def __init__(self, fhe, mesh: Mesh, axis: str = "rns"):
        self.fhe = fhe
        self.mesh = mesh
        self.axis = axis

    def multiply(self, a, b, rlk):
        """Ciphertext multiply + relinearize, explicit-collective path when
        eligible (BFV, rns axis in the mesh, (k - level) % P == 0); falls
        back to the wrapped FHE (auto-partitioned) otherwise."""
        from . import shard_scheme as _ss
        level = a.level
        eligible = (
            self.axis in self.mesh.shape
            and getattr(self.fhe, "scheme_name", "bfv") == "bfv"
            and (self.fhe.ctx.k - level) % self.mesh.shape[self.axis] == 0)
        if not eligible:
            return self.fhe.multiply(a, b, rlk)
        with self.fhe.monitor.time("multiply_shardmap"):
            return _ss.multiply_relin_shardmap(
                self.fhe.ctx, a, b, rlk, self.mesh, self.axis)

    def _sharding(self, ndim: int) -> NamedSharding:
        return NamedSharding(self.mesh, P(self.axis, *([None] * (ndim - 1))))

    def shard(self, obj):
        """Place any key/ciphertext object — or a container of them — with
        its prime axis sharded.  Dispatches on the object type (not the
        pytree leaf), so key material nested in tuples/dicts still gets the
        digit-axis-aware layout."""
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.shard(o) for o in obj)
        if isinstance(obj, dict):
            return {k: self.shard(v) for k, v in obj.items()}
        digit_major = isinstance(obj, (RelinKeys, GaloisKeys))

        def place(leaf):
            if hasattr(leaf, "ndim") and leaf.ndim >= 1:
                if digit_major:
                    # keys-with-digit-axis ([k_digit, k, 2, n]): prime = axis 1
                    spec = P(None, self.axis, *([None] * (leaf.ndim - 2)))
                    return jax.device_put(leaf, NamedSharding(self.mesh, spec))
                return jax.device_put(leaf, self._sharding(leaf.ndim))
            return leaf
        return jax.tree_util.tree_map(place, obj)

    def replicate(self, obj):
        return jax.tree_util.tree_map(
            lambda leaf: jax.device_put(leaf, NamedSharding(self.mesh, P()))
            if hasattr(leaf, "ndim") else leaf, obj)

    # scheme ops pass through the wrapped FHE (jit propagates shardings)
    def __getattr__(self, name):
        return getattr(self.fhe, name)


def shard_batch(mesh: Mesh, stacked: jax.Array, axis: str = "dp") -> jax.Array:
    """Place a [B, ...] stack of ciphertext tensors batch-sharded."""
    spec = P(axis, *([None] * (stacked.ndim - 1)))
    return jax.device_put(stacked, NamedSharding(mesh, spec))
