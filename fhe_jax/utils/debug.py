"""Runtime checking utilities — the counterpart of the reference's debug
tooling (SURVEY.md §5: the reference has only a ``-g -G`` debug build,
``Makefile:113-115``; here ``jax.experimental.checkify`` gives on-device
value checks).

``checked(fn)`` wraps a jittable scheme function so that every residue it
returns is range-checked against its prime modulus — the FHE analog of a
memory sanitizer (a residue >= p means a reduction bug upstream).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def assert_residues_in_range(x: jax.Array, p, name: str = "residues"):
    """checkify assertion: all values of [k, ...] x are < their prime."""
    pb = p.reshape((p.shape[0],) + (1,) * (x.ndim - 1))
    checkify.check(jnp.all(x < pb), f"{name}: residue out of range [0, p)")


def checked(fn, primes_getter=None):
    """Wrap fn so its array outputs are residue-range-checked.

    primes_getter(args, kwargs) -> [k] prime array; defaults to the first
    argument's ``ntt_q.p`` (the SchemeContext convention).

    Returns a function with the same signature; raises
    ``checkify.JaxRuntimeError`` on violation.  Compose under jit freely.
    """
    if primes_getter is None:
        def primes_getter(args, kwargs):
            return args[0].ntt_q.p

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        p = primes_getter(args, kwargs)

        def body(*a, **kw):
            out = fn(*a, **kw)
            for leaf in jax.tree_util.tree_leaves(out):
                if (hasattr(leaf, "dtype") and leaf.dtype == jnp.uint32
                        and leaf.ndim >= 1
                        and leaf.shape[0] == p.shape[0]):
                    assert_residues_in_range(leaf, p, name=fn.__name__)
            return out

        err, out = checkify.checkify(body)(*args, **kwargs)
        err.throw()
        return out

    return wrapper
