#!/usr/bin/env python3
"""Where the device time of the headline context goes, from a profiler trace.

    python scripts/trace_breakdown.py [--out chiprun_out/trace_breakdown.json]

Runs on one GPU (exits non-zero without one) at n=8192, k=3 (bench.py's
headline context).  Each stage is its own jitted function, run ITERS times
inside one ``jax.profiler`` trace; the trace's device kernels are grouped by
their ``hlo_module`` stat (``jit_<function name>``), so every stage gets its
kernel count and device time per call:

  * ntt_fwd_b1 / ntt_fwd_b64     the forward NTT over [3, B, 8192]
  * ntt_mxu_fwd_b1 / _b64        the four-step matmul engine, same shapes
  * mul_relin                    one BFV multiply + relinearize
  * mul_no_relin / relin         its two halves
  * ntts_of_mul_no_relin         the four transforms multiply_no_relin runs
  * ntts_of_relin                the two transforms relinearize runs
  * rotate                       one apply_galois (automorphism + key switch)
  * galois_folded / _gather      the automorphism alone: the folded-affine
                                 path the code takes, and the plain gather

Prints one JSON object and writes it to --out.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ITERS = 20
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}   # NVIDIA H100 SXM data sheet


def kernel_events(pd, plane_prefix: str = "/device:GPU"):
    """(hlo_module, kernel name, start_ns, duration_ns) for every event on a
    device plane that carries an ``hlo_module`` stat.  Derived summary lines
    (names starting with "XLA") are skipped so nothing is counted twice."""
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if line.name.startswith("XLA"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                module = stats.get("hlo_module")
                if module:
                    yield module, ev.name, ev.start_ns, ev.duration_ns


def summarize(events, iters: int) -> dict:
    """Per hlo_module: kernels per call, summed kernel time per call (us),
    busy time per call (union of kernel intervals, us), and the five
    longest kernels by total time."""
    by_mod: dict = {}
    for module, name, start, dur in events:
        by_mod.setdefault(module, []).append((name, start, dur))
    out = {}
    for module, evs in by_mod.items():
        busy, end = 0.0, float("-inf")
        for _, start, dur in sorted(evs, key=lambda e: e[1]):
            lo, hi = max(start, end), start + dur
            if hi > lo:
                busy += hi - lo
            end = max(end, hi)
        per_kernel: dict = {}
        for name, _, dur in evs:
            per_kernel[name] = per_kernel.get(name, 0.0) + dur
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
        out[module] = {
            "kernels_per_call": len(evs) / iters,
            "kernel_us_per_call": sum(e[2] for e in evs) / iters / 1e3,
            "busy_us_per_call": busy / iters / 1e3,
            "top_kernels_us_per_call": {k: v / iters / 1e3 for k, v in top},
        }
    return out


def collect(n: int, iters: int, trace_dir: str, plane_prefix: str) -> dict:
    import numpy as np
    import jax
    import jax.numpy as jnp

    from fhe_jax import FHE
    from fhe_jax.ops import modmath as mm
    from fhe_jax.ops import ntt as _ntt
    from fhe_jax.ops import ntt_mxu as _ntt_mxu
    from fhe_jax.params import SecurityParams, make_scheme_params
    from fhe_jax.scheme import bfv
    from fhe_jax.scheme import context as _context

    fhe = FHE(make_scheme_params(SecurityParams(
        poly_degree=n, log_q=90, hamming_weight=64)), seed=0)
    ctx = fhe.ctx
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    g = pow(3, 1, 2 * n)
    gk = fhe.galoiskey_gen(sk, elements=[g])
    rng = np.random.default_rng(0)
    ca = fhe.encrypt(fhe.encode(rng.integers(0, fhe.params.t, n)), pk)
    cb = fhe.encrypt(fhe.encode(rng.integers(0, fhe.params.t, n)), pk)
    c3 = fhe.multiply_no_relin(ca, cb)
    k, kb = ctx.k, ctx.bsk_counts[0]
    tq, tbsk = ctx.ntt_q, bfv._tb_bsk(ctx, 0)
    tbm = _ntt_mxu.build_mxu_tables(n, fhe.params.q_primes)
    src, neg = _context.galois_perm_tables(n, g)
    p3 = tq.p[:, None, None]

    def rand(rows, b):
        return jnp.asarray(np.stack([rng.integers(0, p, (b, n))
                                     for p in np.asarray(rows)]
                                    ).astype(np.uint32))

    x1, x64 = rand(tq.p, 1), rand(tq.p, 64)
    xq4, xq3, xq2 = rand(tq.p, 4), rand(tq.p, 3), rand(tq.p, 2)
    xb4, xb3 = rand(tbsk.p, 4), rand(tbsk.p, 3)

    def ntt_fwd_b1(x):
        return _ntt.ntt_forward(x, tq)

    def ntt_fwd_b64(x):
        return _ntt.ntt_forward(x, tq)

    def ntt_mxu_fwd_b1(x):
        return _ntt_mxu.ntt_forward(x, tbm)

    def ntt_mxu_fwd_b64(x):
        return _ntt_mxu.ntt_forward(x, tbm)

    def mul_relin(a, b):
        return bfv.multiply(ctx, a, b, rlk).data

    def mul_no_relin(a, b):
        return bfv.multiply_no_relin(ctx, a, b).data

    def relin(c):
        return bfv.relinearize(ctx, c, rlk).data

    def ntts_of_mul_no_relin(q4, q3, b4, b3):
        return (_ntt.ntt_forward(q4, tq), _ntt.ntt_inverse(q3, tq),
                _ntt.ntt_forward(b4, tbsk), _ntt.ntt_inverse(b3, tbsk))

    def ntts_of_relin(q3, q2):
        return _ntt.ntt_forward(q3, tq), _ntt.ntt_inverse(q2, tq)

    def rotate(a):
        return bfv.apply_galois(ctx, a, g, gk).data

    def galois_folded(d):
        return bfv._apply_galois_coeff(ctx, d, g)

    def galois_gather(d):
        gathered = jnp.take(d, src, axis=-1)
        return jnp.where(neg[None, None, :], mm.neg_mod(gathered, p3),
                         gathered)

    stages = [(ntt_fwd_b1, (x1,)), (ntt_fwd_b64, (x64,)),
              (ntt_mxu_fwd_b1, (x1,)), (ntt_mxu_fwd_b64, (x64,)),
              (mul_relin, (ca, cb)), (mul_no_relin, (ca, cb)),
              (relin, (c3,)), (ntts_of_mul_no_relin, (xq4, xq3, xb4, xb3)),
              (ntts_of_relin, (xq3, xq2)), (rotate, (ca,)),
              (galois_folded, (ca.data,)), (galois_gather, (ca.data,))]
    jitted = [(fn.__name__, jax.jit(fn), args) for fn, args in stages]
    want_gather = np.asarray(jax.jit(galois_gather)(ca.data))
    assert np.array_equal(np.asarray(jax.jit(galois_folded)(ca.data)),
                          want_gather), "folded automorphism != plain gather"
    for _, fn, args in jitted:                         # compile + warm up
        jax.block_until_ready(fn(*args))
    with jax.profiler.trace(trace_dir):
        for name, fn, args in jitted:
            with jax.profiler.TraceAnnotation(name):
                for _ in range(iters):
                    jax.block_until_ready(fn(*args))
    path = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                  "*.xplane.pb"))[0]
    pd = jax.profiler.ProfileData.from_file(path)
    lines = {f"{pl.name}|{ln.name}": sum(1 for _ in ln.events)
             for pl in pd.planes if pl.name.startswith(plane_prefix)
             for ln in pl.lines}
    stats = summarize(kernel_events(pd, plane_prefix), iters)
    return {"stats": {k.removeprefix("jit_"): v for k, v in stats.items()},
            "device_lines": lines, "k": k, "kb": kb, "n": n}


def derive(res: dict, kind: str) -> dict:
    """Shares of one multiply+relin and NTT bytes against HBM bandwidth."""
    st, n, k = res["stats"], res["n"], res["k"]
    t = {name: v["kernel_us_per_call"] for name, v in st.items()}
    mul = t["mul_relin"]
    out = {
        "ntt_share_of_mul_relin":
            (t["ntts_of_mul_no_relin"] + t["ntts_of_relin"]) / mul,
        "behz_and_pointwise_share_of_mul_relin":
            (t["mul_no_relin"] - t["ntts_of_mul_no_relin"]) / mul,
        "keyswitch_non_ntt_share_of_mul_relin":
            (t["relin"] - t["ntts_of_relin"]) / mul,
        "halves_sum_over_whole": (t["mul_no_relin"] + t["relin"]) / mul,
    }
    peak = HBM_BYTES_PER_S.get(kind)
    for b in (1, 64):
        # least traffic: read the input and both twiddle tables, write output
        nbytes = 2 * k * b * n * 4 + 2 * k * n * 4
        us = t[f"ntt_fwd_b{b}"]
        out[f"ntt_fwd_b{b}_min_bytes"] = nbytes
        out[f"ntt_fwd_b{b}_bytes_per_s"] = nbytes / (us * 1e-6)
        out[f"ntt_fwd_b{b}_hbm_share"] = (
            nbytes / (us * 1e-6) / peak if peak else None)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/trace_breakdown.json")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args()
    from fhe_jax.utils import compile_cache, device_report

    compile_cache.configure()
    dev = device_report.require_gpu()
    with tempfile.TemporaryDirectory() as trace_dir:
        res = collect(8192, args.iters, trace_dir, "/device:GPU")
    res["derived"] = derive(res, dev["kind"])
    res["device"] = {k: dev[k] for k in ("platform", "kind", "count", "cards")}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
