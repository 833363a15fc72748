"""Multi-device tests on the virtual 8-device CPU mesh (conftest.py).

Validates the distributed coefficient-block NTT (ppermute stage exchanges)
bit-exactly against the single-device engine, and prime-axis (rns) sharding
of full scheme ops — the reference's multi-GPU design existed only in docs
(docs/ARCHITECTURE.md:499-521)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from fhe_jax import FHE, primes
from fhe_jax.params import SecurityParams, make_scheme_params
from fhe_jax.ops import ntt as _ntt
from fhe_jax.parallel import mesh as _mesh
from fhe_jax.parallel import distributed_ntt as dntt
from fhe_jax.scheme import bfv

RNG = np.random.default_rng(5)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


@pytest.mark.parametrize("num_shards", [2, 4, 8])
@pytest.mark.parametrize("n", [256, 1024])
def test_distributed_ntt_bit_exact(eight_devices, num_shards, n):
    k, batch = 2, 2
    ps = primes.find_ntt_primes(n, k)
    tb = _ntt.build_tables(n, ps)
    mesh = _mesh.make_mesh({"coeff": num_shards}, eight_devices)
    a = np.stack([RNG.integers(0, p, (batch, n), dtype=np.uint32) for p in ps])
    b = np.stack([RNG.integers(0, p, (batch, n), dtype=np.uint32) for p in ps])
    sharding = NamedSharding(mesh, P(None, None, "coeff"))
    a_dev = jax.device_put(jnp.asarray(a), sharding)
    b_dev = jax.device_put(jnp.asarray(b), sharding)
    f = dntt.make_distributed_polymul(mesh, tb, n)
    got = np.asarray(f(a_dev, b_dev))
    want = np.asarray(jax.jit(_ntt.polymul_negacyclic)(jnp.asarray(a), jnp.asarray(b), tb))
    np.testing.assert_array_equal(got, want)


def test_distributed_forward_inverse_roundtrip(eight_devices):
    n, k, batch, shards = 512, 3, 1, 8
    ps = primes.find_ntt_primes(n, k)
    tb = _ntt.build_tables(n, ps)
    mesh = _mesh.make_mesh({"coeff": shards}, eight_devices)
    a = np.stack([RNG.integers(0, p, (batch, n), dtype=np.uint32) for p in ps])
    sharding = NamedSharding(mesh, P(None, None, "coeff"))
    a_dev = jax.device_put(jnp.asarray(a), sharding)

    def rt(x, tables):
        y = dntt.dist_ntt_forward(x, tables, n, shards)
        return dntt.dist_ntt_inverse(y, tables, n, shards)

    f = jax.jit(jax.shard_map(
        rt, mesh=mesh,
        in_specs=(P(None, None, "coeff"), P()),
        out_specs=P(None, None, "coeff")))
    got = np.asarray(f(a_dev, tb))
    np.testing.assert_array_equal(got, a)


def test_rns_prime_axis_sharded_pipeline(eight_devices):
    """Full multiply+relin with the prime axis sharded over 8 devices
    (k = 8 primes, one per device — the reference's prime-per-GPU story)."""
    params = make_scheme_params(
        SecurityParams(poly_degree=128, log_q=240, hamming_weight=16))
    assert params.k == 8
    fhe = FHE(params, seed=9)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    ct1 = fhe.encrypt(fhe.encode([4, 5, 6]), pk)
    ct2 = fhe.encrypt(fhe.encode([7, 8, 9]), pk)

    mesh = _mesh.make_mesh({"rns": 8}, eight_devices)
    shard3 = _mesh.rns_sharding(mesh, 3)
    ct1_s = ct1.replace(data=jax.device_put(ct1.data, shard3))
    ct2_s = ct2.replace(data=jax.device_put(ct2.data, shard3))
    out = jax.jit(bfv.multiply)(fhe.ctx, ct1_s, ct2_s, rlk)
    got = fhe.decode(fhe.decrypt(out, sk))
    assert list(got[:3]) == [28, 40, 54]
    # unsharded result must be identical bit-for-bit
    ref = jax.jit(bfv.multiply)(fhe.ctx, ct1, ct2, rlk)
    np.testing.assert_array_equal(np.asarray(out.data), np.asarray(ref.data))


def test_batch_vmap_ciphertexts(eight_devices):
    """Data-parallel batch of ciphertexts via vmap + dp sharding."""
    params = make_scheme_params(
        SecurityParams(poly_degree=128, log_q=60, hamming_weight=16))
    fhe = FHE(params, seed=11)
    pk, sk = fhe.keygen()
    batch = 8
    cts = [fhe.encrypt(fhe.encode([i + 1, 2 * i]), pk) for i in range(batch)]
    stacked = jnp.stack([c.data for c in cts])      # [B, k, 2, n]
    mesh = _mesh.make_mesh({"dp": 8}, eight_devices)
    stacked = jax.device_put(stacked, NamedSharding(mesh, P("dp")))

    def add_self(data):
        ct = cts[0].replace(data=data)
        return bfv.add(fhe.ctx, ct, ct).data

    doubled = jax.jit(jax.vmap(add_self))(stacked)
    for i in range(batch):
        ct = cts[0].replace(data=doubled[i])
        got = fhe.decode(fhe.decrypt(ct, sk))
        assert list(got[:2]) == [(2 * (i + 1)) % 65537, (4 * i) % 65537]


def test_sharded_fhe_wrapper(eight_devices):
    """ShardedFHE convenience API: prime-axis-sharded multiply is bit-exact
    with the single-device result."""
    from fhe_jax.parallel.sharded import ShardedFHE

    params = make_scheme_params(
        SecurityParams(poly_degree=128, log_q=240, hamming_weight=16))
    fhe = FHE(params, seed=23)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    ct1 = fhe.encrypt(fhe.encode([2, 3]), pk)
    ct2 = fhe.encrypt(fhe.encode([5, 7]), pk)

    mesh = _mesh.make_mesh({"rns": 8}, eight_devices)
    sfhe = ShardedFHE(fhe, mesh)
    s1, s2 = sfhe.shard(ct1), sfhe.shard(ct2)
    srlk = sfhe.shard(rlk)
    out = sfhe.multiply(s1, s2, srlk)
    got = fhe.decode(fhe.decrypt(out, sk))
    assert list(got[:2]) == [10, 21]
    ref = fhe.multiply(ct1, ct2, rlk)
    np.testing.assert_array_equal(np.asarray(out.data), np.asarray(ref.data))


def test_sharded_container_dispatch(eight_devices):
    """shard() on containers must keep the digit-axis layout for key
    material nested inside (review finding)."""
    from fhe_jax.parallel.sharded import ShardedFHE

    params = make_scheme_params(
        SecurityParams(poly_degree=128, log_q=240, hamming_weight=16))
    fhe = FHE(params, seed=31)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    mesh = _mesh.make_mesh({"rns": 8}, eight_devices)
    sfhe = ShardedFHE(fhe, mesh)
    bundle = sfhe.shard({"rlk": rlk, "pair": (pk, sk)})
    direct = sfhe.shard(rlk)
    assert bundle["rlk"].data.sharding == direct.data.sharding
    assert bundle["pair"][0].data.sharding == sfhe.shard(pk).data.sharding


def test_distributed_ntt_rejects_non_power_of_two(eight_devices):
    import pytest as _pytest
    ps = primes.find_ntt_primes(256, 1)
    tb = _ntt.build_tables(256, ps)
    mesh = _mesh.make_mesh({"coeff": 6}, eight_devices[:6])
    with _pytest.raises(ValueError, match="power of two"):
        dntt.make_distributed_polymul(mesh, tb, 256)


@pytest.mark.parametrize("n,shards", [(2048, 4), (32768, 8)])
def test_multiply_relin_coeff_sharded(eight_devices, n, shards):
    """Scheme-level COEFFICIENT-sharded multiply+relin (SURVEY §7 stage 7): the BEHZ conversions and key-switch inner
    product run shard-local; only the distributed NTTs' ppermute stages
    communicate.  Bit-exact vs the single-device jnp-engine multiply, and
    decrypt-correct — including n=32768, past the reference's declared max
    ring (docs/NTT_OPTIMIZATION.md:315-325 designed this; no code existed)."""
    params = make_scheme_params(
        SecurityParams(poly_degree=n, log_q=90, lambda_=0, hamming_weight=16))
    fhe = FHE(params, seed=11)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    ct1 = fhe.encrypt(fhe.encode([4, 5, 6]), pk)
    ct2 = fhe.encrypt(fhe.encode([7, 8, 9]), pk)
    mesh = _mesh.make_mesh({"coeff": shards}, eight_devices[:shards])
    out = dntt.multiply_relin_coeff_sharded(fhe.ctx, ct1, ct2, rlk, mesh)
    got = fhe.decode(fhe.decrypt(out, sk))
    assert list(got[:3]) == [28, 40, 54], got[:3]
    want = jax.jit(bfv.multiply)(fhe.ctx, ct1, ct2, rlk)
    np.testing.assert_array_equal(np.asarray(out.data),
                                  np.asarray(want.data))
