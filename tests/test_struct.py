"""fhe_jax.utils.struct: frozen dataclass pytrees (the package's pytrees)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_jax.scheme.types import Ciphertext, GaloisKeys, Plaintext
from fhe_jax.utils import struct


@struct.dataclass
class _Box:
    x: jax.Array
    y: jax.Array
    tag: str = struct.field(pytree_node=False, default="a")


def _samples():
    return [
        Plaintext(data=jnp.arange(8, dtype=jnp.uint32), is_ntt_form=True),
        Ciphertext(data=jnp.ones((2, 2, 8), jnp.uint32), level=1,
                   noise_budget=3.5, scale_t=7),
        GaloisKeys(data={3: jnp.zeros((2, 2, 2, 8), jnp.uint32)}),
        _Box(x=jnp.ones(3), y=jnp.zeros(2), tag="b"),
    ]


@pytest.mark.parametrize("obj", _samples(), ids=lambda o: type(o).__name__)
def test_pytree_round_trip(obj):
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for f in dataclasses.fields(obj):
        a, b = getattr(obj, f.name), getattr(back, f.name)
        if f.metadata.get("pytree_node", True):
            jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
        else:
            assert a == b


def test_static_fields_are_not_leaves():
    ct = Ciphertext(data=jnp.ones((2, 2, 8), jnp.uint32), level=2,
                    is_ntt_form=True, noise_budget=1.0, scale_t=5)
    leaves = jax.tree_util.tree_leaves(ct)
    # data, noise_budget, scale_t are leaves; level and is_ntt_form are not
    assert len(leaves) == 3
    treedef = jax.tree_util.tree_structure(ct)
    other = jax.tree_util.tree_structure(ct.replace(level=3))
    assert treedef != other


def test_replace_returns_modified_copy():
    box = _Box(x=jnp.ones(3), y=jnp.zeros(2))
    new = box.replace(y=jnp.ones(2), tag="z")
    assert box.tag == "a" and new.tag == "z"
    np.testing.assert_array_equal(box.y, np.zeros(2))
    np.testing.assert_array_equal(new.y, np.ones(2))
    assert new.x is box.x


def test_frozen():
    box = _Box(x=jnp.ones(3), y=jnp.zeros(2))
    with pytest.raises(dataclasses.FrozenInstanceError):
        box.tag = "c"


def test_no_retrace_under_jit_for_new_leaf_values():
    traces = []

    @jax.jit
    def f(b):
        traces.append(b.tag)
        return b.x.sum() + b.y.sum()

    f32 = jnp.float32
    assert float(f(_Box(x=jnp.ones(3, f32), y=jnp.zeros(2, f32)))) == 3.0
    assert float(f(_Box(x=jnp.full(3, 2, f32), y=jnp.ones(2, f32)))) == 8.0
    assert traces == ["a"]


def test_static_field_change_retraces():
    traces = []

    @jax.jit
    def f(b):
        traces.append(b.tag)
        return b.x.sum()

    f(_Box(x=jnp.ones(3), y=jnp.zeros(2), tag="p"))
    f(_Box(x=jnp.ones(3), y=jnp.zeros(2), tag="q"))
    assert traces == ["p", "q"]
