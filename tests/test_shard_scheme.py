"""Explicit shard_map scheme path: bit-exactness + collective accounting.

Without it the rns-sharded scheme ops run through GSPMD
auto-partitioning with uncontrolled collectives.  These tests pin the
explicit path (parallel/shard_scheme.py): value-exact against the
single-device BEHZ multiply, and the collective op *counts* asserted from
compiled HLO so a regression that silently adds communication fails CI.
"""

import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_jax import FHE
from fhe_jax.params import SecurityParams, make_scheme_params
from fhe_jax.parallel import mesh as _mesh
from fhe_jax.parallel import shard_scheme
from fhe_jax.scheme import bfv


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


def _setup(k, n=128, seed=7):
    params = make_scheme_params(
        SecurityParams(poly_degree=n, log_q=30 * k, hamming_weight=16))
    assert params.k == k
    fhe = FHE(params, seed=seed)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    ct1 = fhe.encrypt(fhe.encode([4, 5, 6]), pk)
    ct2 = fhe.encrypt(fhe.encode([7, 8, 9]), pk)
    return fhe, sk, rlk, ct1, ct2


@pytest.mark.parametrize("k,p_devs", [(8, 8), (4, 4), (8, 4), (4, 2)])
def test_multiply_relin_shardmap_bitexact(eight_devices, k, p_devs):
    """One prime per device (k == P) and multi-prime-per-device (k > P):
    both bit-exact vs the single-device BEHZ multiply+relin."""
    fhe, sk, rlk, ct1, ct2 = _setup(k)
    mesh = _mesh.make_mesh({"rns": p_devs}, eight_devices[:p_devs])
    out = shard_scheme.multiply_relin_shardmap(fhe.ctx, ct1, ct2, rlk, mesh)
    got = fhe.decode(fhe.decrypt(out, sk))
    assert list(got[:3]) == [28, 40, 54], got[:3]
    want = jax.jit(bfv.multiply)(fhe.ctx, ct1, ct2, rlk)
    np.testing.assert_array_equal(np.asarray(out.data), np.asarray(want.data))


def test_shardmap_rejects_uneven_k(eight_devices):
    fhe, sk, rlk, ct1, ct2 = _setup(3)
    mesh = _mesh.make_mesh({"rns": 2}, eight_devices[:2])
    with pytest.raises(ValueError, match="% P == 0"):
        shard_scheme.multiply_relin_shardmap(fhe.ctx, ct1, ct2, rlk, mesh)


def test_multiply_relin_shardmap_leveled(eight_devices):
    """The explicit path at level 1: level-0 keys
    mod-switched down inside, bit-exact vs the single-device leveled
    multiply."""
    fhe, sk, rlk, ct1, ct2 = _setup(5)
    a1 = fhe.mod_switch_to_next(ct1)
    b1 = fhe.mod_switch_to_next(ct2)
    mesh = _mesh.make_mesh({"rns": 4}, eight_devices[:4])
    out = shard_scheme.multiply_relin_shardmap(fhe.ctx, a1, b1, rlk, mesh)
    assert out.level == 1
    got = fhe.decode(fhe.decrypt(out, sk))
    assert list(got[:3]) == [28, 40, 54], got[:3]
    want = jax.jit(bfv.multiply)(fhe.ctx, a1, b1, rlk)
    np.testing.assert_array_equal(np.asarray(out.data), np.asarray(want.data))


def test_sharded_fhe_routes_explicit_path(eight_devices):
    """ShardedFHE.multiply is the production distributed default: it must
    route through multiply_relin_shardmap when the mesh has the rns axis
    (and fall back cleanly when the prime count does not divide)."""
    from fhe_jax.parallel.sharded import ShardedFHE

    fhe, sk, rlk, ct1, ct2 = _setup(4)
    mesh = _mesh.make_mesh({"rns": 4}, eight_devices[:4])
    sfhe = ShardedFHE(fhe, mesh)
    out = sfhe.multiply(ct1, ct2, rlk)
    got = fhe.decode(fhe.decrypt(out, sk))
    assert list(got[:3]) == [28, 40, 54], got[:3]
    want = shard_scheme.multiply_relin_shardmap(fhe.ctx, ct1, ct2, rlk, mesh)
    np.testing.assert_array_equal(np.asarray(out.data), np.asarray(want.data))
    assert fhe.monitor.get_stats().counts.get("multiply_shardmap", 0) >= 1
    # ineligible (k=4 not divisible by P=3): falls back to the wrapped FHE
    mesh3 = _mesh.make_mesh({"rns": 3}, eight_devices[:3])
    out_fb = ShardedFHE(fhe, mesh3).multiply(ct1, ct2, rlk)
    got_fb = fhe.decode(fhe.decrypt(out_fb, sk))
    assert list(got_fb[:3]) == [28, 40, 54], got_fb[:3]


def test_keyswitch_psum_bitexact(eight_devices):
    """The psum-strategy key switch (digit-sharded partials, exact modular
    all-reduce) matches the composed single-device inner product."""
    fhe, sk, rlk, ct1, ct2 = _setup(4)
    ctx = fhe.ctx
    mesh = _mesh.make_mesh({"rns": 4}, eight_devices[:4])
    ct3 = bfv.multiply_no_relin(ctx, ct1, ct2)
    c2 = ct3.data[:, 2]
    got = shard_scheme.keyswitch_delta_psum(ctx, c2, rlk.data, mesh)
    want = bfv._keyswitch_delta(ctx, c2, rlk.data, 0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _collective_counts(hlo_text: str) -> dict:
    return {
        "all-gather": len(re.findall(r"all-gather(?:-start)?\(", hlo_text)),
        "all-reduce": len(re.findall(r"all-reduce(?:-start)?\(", hlo_text)),
        "all-to-all": len(re.findall(r"all-to-all(?:\.\d+)?\(", hlo_text)),
        "collective-permute": len(
            re.findall(r"collective-permute(?:-start)?\(", hlo_text)),
    }


def test_multiply_shardmap_collective_inventory(eight_devices):
    """The gather-strategy multiply must compile to all-gathers ONLY — the
    module docstring's 4-exchange inventory; GSPMD may merge adjacent
    gathers, so assert 1..4 gathers and zero other collectives."""
    fhe, sk, rlk, ct1, ct2 = _setup(8)
    ctx = fhe.ctx
    mesh = _mesh.make_mesh({"rns": 8}, eight_devices)
    plan = shard_scheme.build_plan(ctx, 8)
    fn = shard_scheme._build_shardmap_fn(ctx, mesh, "rns", plan)
    keys_t = jnp.transpose(rlk.data, (1, 0, 2, 3))
    args = (ct1.data, ct2.data, keys_t, plan["qc"], plan["bc"],
            ctx.ntt_q, plan["tb_bsk"])
    txt = fn.lower(*args).compile().as_text()
    counts = _collective_counts(txt)
    assert 1 <= counts["all-gather"] <= 4, counts
    assert counts["all-reduce"] == 0, counts
    assert counts["all-to-all"] == 0, counts
    assert counts["collective-permute"] == 0, counts


def test_psum_keyswitch_collective_inventory(eight_devices):
    """The psum strategy must compile to all-reduces (the 16-bit-split pair;
    GSPMD may fuse them into one) and no gathers of the digit tensor."""
    fhe, sk, rlk, ct1, ct2 = _setup(4)
    ctx = fhe.ctx
    mesh = _mesh.make_mesh({"rns": 4}, eight_devices[:4])
    ct3 = bfv.multiply_no_relin(ctx, ct1, ct2)
    c2 = ct3.data[:, 2]

    def run(poly, keys):
        return shard_scheme.keyswitch_delta_psum(ctx, poly, keys, mesh)

    txt = jax.jit(run).lower(c2, rlk.data).compile().as_text()
    counts = _collective_counts(txt)
    assert counts["all-reduce"] >= 1, counts


def test_psum_mod_exactness(eight_devices):
    """psum_mod: the 16-bit-split all-reduce equals the exact modular sum
    for worst-case residues (all devices holding p-1)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    import fhe_jax.ops.modmath as mm

    p = 1073479681  # 30-bit NTT prime
    sh16 = mm.shoup_precompute(1 << 16, p)
    mesh = _mesh.make_mesh({"rns": 8}, eight_devices)
    x = jnp.full((8, 4, 16), p - 1, jnp.uint32)

    def local(v):
        return shard_scheme.psum_mod(
            v[0], jnp.uint32(p), jnp.uint32(sh16), "rns")[None]

    got = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("rns"),),
                            out_specs=P("rns"), check_vma=False))(x)
    want = (8 * (p - 1)) % p
    assert (np.asarray(got) == want).all()
