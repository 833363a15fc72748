"""checkify-based residue-range sanitizer tests (SURVEY.md §5 'race
detection/sanitizers': the JAX equivalents of compute-sanitizer)."""

import jax.numpy as jnp
import pytest
from jax.experimental import checkify

from fhe_jax import FHE
from fhe_jax.scheme import bfv
from fhe_jax.utils import debug


@pytest.fixture(scope="module")
def small():
    fhe = FHE(poly_degree=256, log_q=60, seed=1)
    pk, sk = fhe.keygen()
    return fhe, pk, sk


def test_checked_passes_on_valid_op(small):
    fhe, pk, sk = small
    ct = fhe.encrypt(fhe.encode([1, 2]), pk)
    checked_add = debug.checked(bfv.add)
    out = checked_add(fhe.ctx, ct, ct)
    got = fhe.decode(fhe.decrypt(out, sk))
    assert list(got[:2]) == [2, 4]


def test_checked_catches_out_of_range(small):
    fhe, pk, sk = small
    ct = fhe.encrypt(fhe.encode([1]), pk)
    # inject a corrupted residue >= p (a reduction bug would produce this)
    bad = ct.replace(data=ct.data.at[0, 0, 0].set(jnp.uint32(0xFFFFFFFF)))

    def identity(ctx, c):
        return c

    checked_id = debug.checked(identity)
    with pytest.raises(checkify.JaxRuntimeError):
        checked_id(fhe.ctx, bad)
