#!/usr/bin/env python3
"""Multi-process data-parallel benchmark: one JAX process per card.

Initializes ``jax.distributed``, builds a global ``dp`` mesh over every
card of every process, and measures BFV ciphertext-multiply throughput with
the global batch sharded across all cards.  On one NVLink host every card
reaches every other at the same rate, so the mesh is a flat device list.

Launch one process per card on this host (the parent stays off JAX and
pins child i to card i with ``CUDA_VISIBLE_DEVICES``):

    python scripts/multihost_bench.py --local-processes 4

Or start each process yourself, e.g. across hosts:

    python scripts/multihost_bench.py \\
        --coordinator=<host0>:8476 --num-processes=2 --process-id=$ID

With no flags it runs as one process on the local devices.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(args) -> int:
    """Start args.local_processes children on localhost, child i pinned to
    card i; wait for all of them and return the first non-zero exit code."""
    port = _free_port()
    procs = []
    for i in range(args.local_processes):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(i))
        cmd = [sys.executable, os.path.abspath(__file__),
               f"--coordinator=localhost:{port}",
               f"--num-processes={args.local_processes}",
               f"--process-id={i}", f"--n={args.n}",
               f"--batch-per-chip={args.batch_per_chip}"]
        if args.out and i == 0:
            cmd.append(f"--out={args.out}")
        procs.append(subprocess.Popen(cmd, env=env))
    rcs = [p.wait() for p in procs]
    return next((rc for rc in rcs if rc), 0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--local-processes", type=int, default=0,
                    help="launch this many local processes, one per card")
    ap.add_argument("--coordinator", default=None,
                    help="process 0's address:port for jax.distributed")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--batch-per-chip", type=int, default=4)
    ap.add_argument("--out", default=None,
                    help="also write process 0's JSON line to this file")
    args = ap.parse_args()
    if args.local_processes:
        sys.exit(launch_local(args))

    import jax
    if args.coordinator:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fhe_jax import FHE
    from fhe_jax.params import SecurityParams, make_scheme_params
    from fhe_jax.parallel.mesh import make_mesh
    from fhe_jax.scheme import bfv
    from fhe_jax.utils import compile_cache

    compile_cache.configure()
    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    batch = args.batch_per_chip * n_global

    params = make_scheme_params(
        SecurityParams(poly_degree=args.n, log_q=90, hamming_weight=64))
    fhe = FHE(params, seed=0)
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    ct1 = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
    ct2 = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)

    mesh = make_mesh({"dp": n_global})
    sharding = NamedSharding(mesh, P("dp"))
    host_stack = np.broadcast_to(np.asarray(ct1.data),
                                 (batch, *ct1.data.shape))
    # every process holds the same full host copy -> build the global array
    # shard-by-shard (device_put of a host array to a multi-process sharding
    # is not supported)
    stack = jax.make_array_from_callback(
        host_stack.shape, sharding, lambda idx: host_stack[idx])

    f = jax.jit(
        jax.vmap(lambda a: bfv.multiply(
            fhe.ctx, ct1.replace(data=a), ct2, rlk).data),
        out_shardings=sharding)

    r = f(stack)
    r.block_until_ready()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        r = f(stack)
        r.block_until_ready()
        best = min(best, time.perf_counter() - t0)
    rate = batch / best

    # decrypt-correctness gate on this process's first shard
    local0 = np.asarray(jax.device_get(r.addressable_shards[0].data))[0]
    got = fhe.decode(fhe.decrypt(ct1.replace(data=jnp.asarray(local0)), sk))
    assert list(got[:4]) == [15, 60, 135, 240], got[:4]

    if args.process_id == 0:
        dev = jax.devices()[0]
        line = json.dumps({
            "metric": "bfv_ct_multiply_multiprocess",
            "processes": jax.process_count(),
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "chips_local": n_local,
            "chips_global": n_global,
            "global_batch": batch,
            "ct_mul_per_s": round(rate, 1),
            "ct_mul_per_s_per_chip": round(rate / n_global, 1),
        })
        print(line)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(line + "\n")


if __name__ == "__main__":
    main()
