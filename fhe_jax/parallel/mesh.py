"""Device mesh helpers.

The scalable axes of this workload (SURVEY.md §5 "long-context analog") are:
  * ``rns``   — the RNS prime axis: per-prime NTTs are embarrassingly
    parallel (the reference ran one CUDA stream per prime,
    ``src/ntt.cu:137-141``; we shard the leading k axis across chips),
  * ``coeff`` — polynomial-coefficient blocks for large n (cross-shard
    butterfly stages exchange blocks; distributed_ntt.py),
  * ``batch`` — independent ciphertexts (pure data parallelism).

Every device of one NVLink host reaches every other at the same rate, so a
mesh is a flat list of devices shaped by the algorithm alone.  Multi-host:
the same program runs under ``jax.distributed.initialize`` (nothing here is
host-count aware).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """mesh from {'axis': size}; default: all devices on the 'rns' axis."""
    devices = devices if devices is not None else jax.devices()
    if axes is None:
        axes = {"rns": len(devices)}
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev, names)


def rns_sharding(mesh: Mesh, ndim: int, axis: str = "rns") -> NamedSharding:
    """Shard the leading (prime) axis of a [k, ..., n] residue tensor."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
