"""Frozen dataclass pytrees.

``@dataclass`` turns a class into a frozen dataclass registered with JAX:
fields declared with ``field(pytree_node=False)`` are static metadata (part
of the treedef, so a new value retraces a jitted function), every other
field is a leaf.  ``.replace(**changes)`` returns a modified copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=meta)
