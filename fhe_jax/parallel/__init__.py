"""Multi-chip distribution: RNS prime-axis sharding and the distributed
coefficient-block NTT (jax collectives under shard_map — the code for the
reference's doc-only multi-GPU RNS design,
``docs/ARCHITECTURE.md:499-521``)."""

from .mesh import make_mesh, rns_sharding
from .distributed_ntt import dist_ntt_forward, dist_ntt_inverse
from .sharded import ShardedFHE, shard_batch
from .shard_scheme import keyswitch_delta_psum, multiply_relin_shardmap

__all__ = ["make_mesh", "rns_sharding", "dist_ntt_forward", "dist_ntt_inverse",
           "ShardedFHE", "shard_batch", "multiply_relin_shardmap",
           "keyswitch_delta_psum"]
