"""Benchmark: BFV ciphertext multiply+relinearize and forward NTT on one GPU.

Prints a JSON line per completed group; THE LAST STDOUT LINE IS THE RESULT:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., "extra": {...}}

  * The headline multiply+relin chain is built, golden-checked, and sampled
    FIRST, and a complete, valid, <2 KB compact line is printed (and
    flushed) as soon as it is done.
  * Every subsequent benchmark group (NTT, rotations, k=8, n=16384, BGV,
    bootstrap, the four-step matmul engine, n=32768) re-prints the updated
    compact line when it completes, so the tail of stdout always holds a
    valid line with everything measured so far.
  * Contexts are built lazily, per group.
  * A wall-clock budget (env FHE_BENCH_BUDGET_S, default 900 s) gates each
    group start and each sampling round; when it expires the bench stops
    starting new work, emits the final line, and exits 0.
  * It runs only on a GPU: without one it exits non-zero before timing
    anything.  Every line names the device (platform, device_kind, count)
    and the card's name and power limit from nvidia-smi.

Baseline of record (BASELINE.md): the reference's documented RTX 4090 numbers
  * homomorphic multiply incl. relinearization: ~40 ms  -> 25 ops/s
  * forward NTT, n=8192: 1.89 ms                        -> 529 transforms/s
Config matches BASELINE.json: n=8192, 3 RNS primes (q ~ 2^90).

Measurement method:

  * Every op is timed as a DATA-DEPENDENT chain inside one jit, and the
    per-op time is the two-point slope (T(hi) - T(lo)) / (hi - lo), which
    cancels the fixed per-dispatch cost.
  * Chains are sampled in a ROUND-ROBIN within their group: one (hi, lo)
    slope per chain per round, ROUNDS rounds interleaved, reported as the
    MEDIAN slope with a jitter field (median-absolute-deviation/median, %).
    A/B comparisons (hoisted/plain, single/batched, four-step/stage-sweep)
    live in the same group so they stay interleaved by construction.
  * Anti-DCE: every chain's carried value depends on EVERY element of the
    step output, so XLA cannot hoist or dead-code the measured work.
  * A 4-byte host readback between timed regions (_hard_sync) makes each
    timed dispatch start from a settled queue.

`python bench.py` (first compile is slow, then cached in .jax_cache/ or
$JAX_COMPILATION_CACHE_DIR).  `FHE_BENCH_BUDGET_S=1e9 python bench.py`
removes the budget for full sweeps.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import jax
import jax.lax as lax
import jax.numpy as jnp
import jax.random as jrandom

BASELINE_MUL_MS = 40.0      # BASELINE.md: multiply incl. relin, RTX 4090
BASELINE_NTT_MS = 1.89      # BASELINE.md: forward NTT n=8192, RTX 4090
ROUNDS = 7
BUDGET_S = float(os.environ.get("FHE_BENCH_BUDGET_S", "900"))
T_START = time.time()


def _elapsed():
    return time.time() - T_START


def _median(xs):
    s = sorted(xs)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


def fold_u32(x) -> jax.Array:
    """Wrapping-u32 sum of every element: a cheap anti-DCE fold (the value
    wraps mod 2^32, which is fine for a carried perturbation seed)."""
    return jnp.sum(x, dtype=jnp.uint32)


def _hard_sync(r):
    """block_until_ready + a 4-byte host readback, so the next timed
    dispatch starts from a settled queue."""
    jax.block_until_ready(r)
    leaf = jax.tree_util.tree_leaves(r)[0]
    np.asarray(leaf[(0,) * leaf.ndim] if leaf.ndim else leaf)


class Chain:
    """step(carry) -> carry, timed by the interleaved two-point slope."""

    def __init__(self, name, step, x, hi, lo, div=1.0):
        self.name, self.div = name, div
        self.hi, self.lo = hi, lo
        self.x = x
        self.g_hi = jax.jit(
            lambda v: lax.fori_loop(0, hi, lambda i, y: step(y), v))
        self.g_lo = jax.jit(
            lambda v: lax.fori_loop(0, lo, lambda i, y: step(y), v))
        self.slopes = []

    def warm(self):
        _hard_sync(self.g_hi(self.x))
        _hard_sync(self.g_lo(self.x))

    def sample(self):
        t0 = time.perf_counter()
        r = self.g_hi(self.x)
        jax.block_until_ready(r)
        t_hi = time.perf_counter() - t0
        _hard_sync(r)
        t0 = time.perf_counter()
        r = self.g_lo(self.x)
        jax.block_until_ready(r)
        t_lo = time.perf_counter() - t0
        _hard_sync(r)
        self.slopes.append((t_hi - t_lo) / (self.hi - self.lo))

    def result(self):
        """(seconds_per_op, jitter_pct)."""
        med = _median(self.slopes)
        if med <= 0:
            return 1e-9 / self.div, 999.0
        jit = 100.0 * _median([abs(s - med) for s in self.slopes]) / med
        return med / self.div, round(jit, 1)


class KeyedChain(Chain):
    """step(prng_key, carry_u32_scalar) -> carry (keyed ops: encrypt,
    keygen, ...).  The carry must fold the FULL step output (anti-DCE)."""

    def __init__(self, name, step, hi, lo, div=1.0):
        base_key = jrandom.PRNGKey(42)

        def loop(iters):
            def body(i, c):
                return step(jrandom.fold_in(base_key, i), c)
            return jax.jit(
                lambda c: lax.fori_loop(0, iters, body, c))

        self.name, self.div = name, div
        self.hi, self.lo = hi, lo
        self.x = jnp.zeros((), jnp.uint32)
        self.g_hi = loop(hi)
        self.g_lo = loop(lo)
        self.slopes = []


def run_rounds(chains, rounds=ROUNDS):
    """Warm + interleave-sample a group of chains; budget-aware: stops
    adding rounds past the deadline (keeps >= 3 so the median is real)."""
    t0 = time.time()
    for c in chains:
        c.warm()
    t_warm = time.time() - t0
    t0 = time.time()
    done = rounds
    for r in range(rounds):
        if r >= 3 and _elapsed() > BUDGET_S * 1.15:
            done = r
            break
        for c in chains:
            c.sample()
    print(f"#   warm {t_warm:.1f}s, {done} rounds {time.time() - t0:.1f}s",
          flush=True)
    return {c.name: c.result() for c in chains}


def _rnd(v, d=4):
    return round(v, d) if v is not None else None


class Bench:
    """Accumulates per-chain results across groups; emits the compact line
    (and the BENCH_DETAIL.json side file) after every group so the last
    stdout line is always a complete, current, parseable result."""

    def __init__(self):
        self.res = {}        # chain name -> (seconds_per_op, jitter_pct)
        self.manual = {}     # manually-timed metrics (bootstrap), ms values
        self.aux = {}        # slot_count, params, device, groups_done

    def merge(self, res):
        self.res.update(res)

    def _ms(self, name):
        return self.res[name][0] * 1e3 if name in self.res else None

    def payload(self):
        res, manual, aux = self.res, self.manual, self.aux
        ms = self._ms
        mul_ms = ms("mul")

        extra = {
            "harness": f"median-of-{ROUNDS} interleaved two-point slopes",
            "multiply_relin_ms": _rnd(mul_ms),
            "multiply_relin_ms_batched": _rnd(ms("mul_b8")),
            "multiply_relin_ms_level1": _rnd(ms("mul_l1")),
            "multiply_relin_ms_n16384": _rnd(ms("mul_n16384")),
            "multiply_relin_ms_n16384_omega2": _rnd(ms("mul_n16384_w2")),
            "multiply_relin_ms_k8": _rnd(ms("mul_k8")),
            "multiply_relin_ms_k8_omega2": _rnd(ms("mul_k8_w2")),
            "rotate_rows_ms_k8_omega2": _rnd(ms("rot_k8_w2")),
            "multiply_relin_ms_mxu_engine": _rnd(ms("mul_mxu")),
            "relin_share_k8": (
                _rnd(max(0.0, 1.0 - res["tens_k8"][0] / res["mul_k8"][0]), 3)
                if "tens_k8" in res and "mul_k8" in res else None),
            "forward_ntt_ms": _rnd(ms("ntt")),
            "forward_ntt_ms_batched": _rnd(ms("ntt_b64")),
            "forward_ntt_vs_baseline": (
                _rnd(BASELINE_NTT_MS / ms("ntt"), 3) if ms("ntt") else None),
            "forward_ntt_vs_baseline_batched": (
                _rnd(BASELINE_NTT_MS / ms("ntt_b64"), 3)
                if ms("ntt_b64") else None),
            "forward_ntt_mxu_ms": _rnd(ms("ntt_mxu")),
            "forward_ntt_mxu_ms_batched": _rnd(ms("ntt_mxu_b64")),
            "forward_ntt_ms_n16384": _rnd(ms("ntt_n16384")),
            "forward_ntt_ms_n32768": _rnd(ms("ntt_n32768")),
            "encrypt_ms": _rnd(ms("enc")),
            "encrypt_vs_baseline": (
                _rnd(8.0 / ms("enc"), 3) if ms("enc") else None),
            "encrypt_ms_batched": _rnd(ms("enc_b8")),
            "decrypt_ms": _rnd(ms("dec")),
            "decrypt_vs_baseline": (
                _rnd(3.0 / ms("dec"), 3) if ms("dec") else None),
            "decrypt_ms_batched": _rnd(ms("dec_b8")),
            "hom_add_ms": _rnd(ms("add")),
            "hom_add_vs_baseline": (
                _rnd(0.1 / max(ms("add"), 1e-5), 3) if ms("add") else None),
            "rotate_rows_ms": _rnd(ms("rot")),
            "rotate_hoisted_ms_per_rot": _rnd(ms("rot_hoist")),
            "rotate_rows_ms_batched": _rnd(ms("rot_b8")),
            "rotate_rows_ms_k8": _rnd(ms("rot_k8")),
            "rotate_hoisted_ms_per_rot_k8": _rnd(ms("rot_hoist_k8")),
            "rotate_hoisted_ms_per_rot_k8_omega2": _rnd(ms("rot_hoist_k8_w2")),
            "rotate_hoisted_b4_ms_per_rot_k8": _rnd(ms("rot_hoist_k8_b4")),
            "sum_slots_ms": _rnd(ms("sum_slots")),
            "pt_mac8_resident_ms": _rnd(ms("pt_mac8_resident")),
            "pt_mac8_coeff_ms": _rnd(ms("pt_mac8_coeff")),
            "residency_speedup": (
                _rnd(res["pt_mac8_coeff"][0] / res["pt_mac8_resident"][0], 2)
                if "pt_mac8_resident" in res and "pt_mac8_coeff" in res
                else None),
            "keygen_ms": _rnd(ms("keygen")),
            "keygen_vs_baseline": (
                _rnd(100.0 / ms("keygen"), 3) if ms("keygen") else None),
            "bgv_multiply_relin_ms": _rnd(ms("bgv_mul")),
            "bgv_multiply_vs_baseline": (
                _rnd(BASELINE_MUL_MS / ms("bgv_mul"), 3)
                if ms("bgv_mul") else None),
            "leveled_per_prime_ratio": (
                _rnd((res["mul_l1"][0] / (aux["k"] - 1))
                     / (res["mul"][0] / aux["k"]), 3)
                if "mul_l1" in res and "mul" in res else None),
            "external_product_us": (
                _rnd(res["ext_prod"][0] * 1e6, 3)
                if "ext_prod" in res else None),
            "simd_values_per_s": (
                round(aux["slot_count"] / res["enc_b8"][0], 1)
                if "enc_b8" in res and "slot_count" in aux else None),
        }
        if extra["simd_values_per_s"]:
            extra["simd_vs_baseline"] = _rnd(
                extra["simd_values_per_s"] / 256000.0, 3)
        extra.update(manual)   # bootstrap_ms_n1024, bootstrap_ms_n1024_b8

        jitter = {name: res[name][1] for name in res}
        extra["jitter_pct"] = jitter
        extra["max_jitter_pct"] = max(jitter.values()) if jitter else None
        extra["device"] = aux.get("device")
        extra["n"] = aux.get("n")
        extra["rns_primes"] = aux.get("k")
        extra["groups_done"] = aux.get("groups_done", [])
        extra["elapsed_s"] = round(_elapsed(), 1)

        ops_per_s = (1.0 / res["mul"][0]) if "mul" in res else 0.0
        return {
            "metric": "bfv_ct_multiply_relin_n8192_k3",
            "value": round(ops_per_s, 3),
            "unit": "ops/s",
            "vs_baseline": round(ops_per_s / (1000.0 / BASELINE_MUL_MS), 3),
            "extra": extra,
        }

    HEADLINE_KEYS = (
        "multiply_relin_ms", "multiply_relin_ms_batched",
        "multiply_relin_ms_k8", "multiply_relin_ms_k8_omega2",
        "rotate_rows_ms_k8_omega2", "multiply_relin_ms_n16384",
        "multiply_relin_ms_n16384_omega2",
        "forward_ntt_ms", "forward_ntt_ms_batched",
        "encrypt_ms", "decrypt_ms", "decrypt_ms_batched",
        "rotate_rows_ms", "rotate_hoisted_ms_per_rot",
        "rotate_hoisted_ms_per_rot_k8", "rotate_rows_ms_k8",
        "rotate_hoisted_ms_per_rot_k8_omega2",
        "rotate_hoisted_b4_ms_per_rot_k8",
        "sum_slots_ms", "keygen_ms",
        "pt_mac8_resident_ms", "pt_mac8_coeff_ms", "residency_speedup",
        "bootstrap_ms_n1024", "bootstrap_ms_n1024_b8",
        "external_product_us", "bgv_multiply_relin_ms",
        "multiply_relin_ms_mxu_engine", "forward_ntt_mxu_ms",
        "forward_ntt_mxu_ms_batched", "forward_ntt_ms_n32768",
        "max_jitter_pct", "device", "n", "rns_primes",
        "groups_done", "elapsed_s",
    )

    def emit(self):
        """Write BENCH_DETAIL.json and print the compact line (flushed).
        Called after EVERY group: the last stdout line always wins and is
        always a complete snapshot of everything measured so far."""
        detail = self.payload()
        try:
            with open("BENCH_DETAIL.json", "w") as f:
                json.dump(detail, f, indent=1)
        except OSError:
            pass
        extra = detail["extra"]
        compact = {k: extra[k] for k in self.HEADLINE_KEYS
                   if extra.get(k) is not None}
        line = json.dumps(dict(detail, extra=compact))
        assert len(line) < 2048, f"headline line too long: {len(line)}"
        print(line, flush=True)


def main():
    from fhe_jax import FHE, oracle
    from fhe_jax.params import SecurityParams, make_scheme_params
    from fhe_jax.ops import modmath as mmx
    from fhe_jax.ops import ntt as _ntt
    from fhe_jax.scheme import bfv
    from fhe_jax.utils import compile_cache, device_report
    from fhe_jax import primes as _primes
    import warnings as _warnings

    compile_cache.configure()
    dev = device_report.require_gpu()
    n = 8192
    bench = Bench()
    bench.aux["n"] = n
    bench.aux["device"] = {k: dev[k] for k in
                           ("platform", "kind", "count", "cards")}
    env = {}   # shared objects across groups (contexts, keys, cts)

    # ---------------- group builders ----------------
    # Each returns a list of chains (golden-checked during build); manual
    # timings go straight into bench.manual.  Headline first, then breadth.

    def g_headline():
        params = make_scheme_params(
            SecurityParams(poly_degree=n, log_q=90, hamming_weight=64))
        assert params.k == 3
        bench.aux["k"] = params.k
        fhe = FHE(params, seed=0)
        pk, sk = fhe.keygen()
        rlk = fhe.relinkey_gen(sk)
        ct1 = fhe.encrypt(fhe.encode([5, 10, 15, 20]), pk)
        ct2 = fhe.encrypt(fhe.encode([3, 6, 9, 12]), pk)
        ctx = fhe.ctx
        # correctness gate BEFORE timing: the numbers only count if the
        # math is right
        got = fhe.decode(fhe.decrypt(fhe.multiply(ct1, ct2, rlk), sk))
        assert list(got[:4]) == [15, 60, 135, 240], got[:4]
        bench.aux["slot_count"] = fhe.slot_count
        env.update(params=params, fhe=fhe, pk=pk, sk=sk, rlk=rlk,
                   ct1=ct1, ct2=ct2, ctx=ctx,
                   p3=ctx.ntt_q.p[:, None, None])
        return [Chain("mul", lambda a: bfv.multiply(
            ctx, ct1.replace(data=a), ct2, rlk).data, ct1.data,
            hi=305, lo=20)]

    def g_mul_variants():
        fhe, ctx = env["fhe"], env["ctx"]
        ct1, ct2, rlk = env["ct1"], env["ct2"], env["rlk"]
        ct1_l1 = fhe.mod_switch_to_next(ct1)
        ct2_l1 = fhe.mod_switch_to_next(ct2)
        rlk_l1 = fhe._rlk_at(rlk, 1)
        chains = [Chain("mul_l1", lambda a: bfv.multiply(
            ctx, ct1_l1.replace(data=a), ct2_l1, rlk_l1,
            keys_at_level=True).data, ct1_l1.data, hi=150, lo=10)]

        cts_b8 = [ct2] * 8
        batch8 = jnp.stack([ct1.data] * 8)

        def mul_batch_step(a_st):
            outs = bfv.multiply_batch(
                ctx, [ct1.replace(data=a_st[i]) for i in range(8)],
                cts_b8, rlk)
            return jnp.stack([o.data[:, :2] for o in outs])

        got_b8 = fhe.decode(fhe.decrypt(
            bfv.multiply_batch(ctx, [ct1] * 8, cts_b8, rlk)[3], env["sk"]))
        assert list(got_b8[:4]) == [15, 60, 135, 240], got_b8[:4]
        chains.append(Chain("mul_b8", mul_batch_step, batch8,
                            hi=45, lo=5, div=8.0))
        return chains

    def g_ntt():
        ctx, ct1 = env["ctx"], env["ct1"]
        one_poly = ct1.data[:, :1, :]
        big64 = jnp.tile(one_poly, (1, 64, 1))
        env["one_poly"] = one_poly

        def fwd(x):
            return _ntt.ntt_forward(x, ctx.ntt_q)

        return [Chain("ntt", fwd, one_poly, hi=3005, lo=105),
                Chain("ntt_b64", fwd, big64, hi=305, lo=15, div=64.0)]

    def g_rotations():
        fhe, ctx = env["fhe"], env["ctx"]
        ct1, sk, p3 = env["ct1"], env["sk"], env["p3"]
        gk = fhe.galoiskey_gen(sk)
        got_r = fhe.decode(fhe.decrypt(fhe.rotate_rows(ct1, 1, gk), sk))
        assert list(got_r[:3]) == [10, 15, 20], got_r[:4]
        chains = [Chain("rot", lambda a: bfv.rotate_rows(
            ctx, ct1.replace(data=a), 1, gk).data, ct1.data, hi=405, lo=25)]

        hoist_elems = tuple(pow(3, s, 2 * n) for s in range(1, 9))
        env["hoist_elems"] = hoist_elems
        gk_h = fhe.galoiskey_gen(sk, elements=hoist_elems)

        def rot_hoist_step(a):
            outs = bfv.apply_galois_hoisted(
                ctx, ct1.replace(data=a), hoist_elems, gk_h)
            return mmx.add_mod_tree(jnp.stack([o.data for o in outs]),
                                    p3[None], axis=0)[0]

        chains.append(Chain("rot_hoist", rot_hoist_step, ct1.data,
                            hi=85, lo=5, div=8.0))

        def rot_batch_step(a_st):
            outs = bfv.rotate_rows_batch(
                ctx, [ct1.replace(data=a_st[i]) for i in range(8)], 1, gk)
            return jnp.stack([o.data for o in outs])

        chains.append(Chain("rot_b8", rot_batch_step,
                            jnp.stack([ct1.data] * 8), hi=85, lo=5, div=8.0))

        gk_ss = fhe.galoiskey_gen(sk, elements=fhe.sum_slots_elements())
        got_ss = fhe.decode(fhe.decrypt(fhe.sum_slots(ct1, gk_ss), sk))
        want_ss = (5 + 10 + 15 + 20) % env["params"].t
        assert int(got_ss[0]) == want_ss and int(got_ss[-1]) == want_ss
        chains.append(Chain("sum_slots", lambda a: fhe.sum_slots(
            ct1.replace(data=a), gk_ss).data, ct1.data, hi=45, lo=5))
        return chains

    def g_residency():
        """NTT-form residency (reference include/fhe.cuh:68):
        an 8-term plaintext dot product (multiply-accumulate) entirely in
        eval domain (1 NTT + 1 INTT total) vs the coefficient-domain chain
        (each product pays its own INTT; the shared forward transform CSEs
        either way).  Both use cached NTT-form plaintext operands."""
        fhe, ctx = env["fhe"], env["ctx"]
        ct1, sk = env["ct1"], env["sk"]
        t = env["params"].t
        vals = [[i + 1, 2 * i + 1, 3, 4] for i in range(8)]
        pts = [fhe.encode(v) for v in vals]
        ops = [bfv.plain_ntt_operand(ctx, pt) for pt in pts]

        def mac(d, resident):
            ct = ct1.replace(data=d)
            if resident:
                ct = bfv.to_ntt(ctx, ct)
            acc = None
            for pt, op in zip(pts, ops):
                term = bfv.multiply_plain(ctx, ct, pt, pt_ntt=op)
                acc = term if acc is None else bfv.add(ctx, acc, term)
            return bfv.to_coeff(ctx, acc).data

        got_r = fhe.decode(fhe.decrypt(
            ct1.replace(data=jax.jit(mac, static_argnums=1)(ct1.data, True)),
            sk))
        want0 = sum(5 * v[0] for v in vals) % t
        assert int(got_r[0]) == want0, (got_r[0], want0)
        got_c = fhe.decode(fhe.decrypt(
            ct1.replace(data=jax.jit(mac, static_argnums=1)(ct1.data, False)),
            sk))
        assert int(got_c[0]) == want0, (got_c[0], want0)
        return [Chain("pt_mac8_resident", lambda d: mac(d, True),
                      ct1.data, hi=605, lo=35),
                Chain("pt_mac8_coeff", lambda d: mac(d, False),
                      ct1.data, hi=205, lo=15)]

    def g_enc_dec():
        fhe, ctx = env["fhe"], env["ctx"]
        ct1, ct2, pk, sk = env["ct1"], env["ct2"], env["pk"], env["sk"]
        pt = fhe.encode([5, 10, 15, 20])
        chains = [KeyedChain("enc", lambda k, c: fold_u32(
            bfv.encrypt(ctx, jrandom.fold_in(k, c), pk, pt).data),
            hi=150, lo=10)]

        def dec_step(k, c):
            d = ct1.data.at[0, 0, 0].set(c % jnp.uint32(3))
            return fold_u32(bfv.decrypt(ctx, ct1.replace(data=d), sk).data)

        chains.append(KeyedChain("dec", dec_step, hi=905, lo=45))

        pts8 = [pt] * 8
        chains.append(KeyedChain("enc_b8", lambda k, c: fold_u32(jnp.stack(
            [o.data for o in bfv.encrypt_batch(
                ctx, jrandom.fold_in(k, c), pk, pts8)])),
            hi=105, lo=10, div=8.0))
        cts8 = bfv.encrypt_batch(ctx, jrandom.PRNGKey(9), pk, pts8)

        def decB_step(k, c):
            d = ct1.data.at[0, 0, 0].set(c % jnp.uint32(3))
            return fold_u32(jnp.stack([o.data for o in bfv.decrypt_batch(
                ctx, [ct1.replace(data=d)] + cts8[1:], sk)]))

        chains.append(KeyedChain("dec_b8", decB_step, hi=105, lo=10, div=8.0))
        chains.append(Chain("add", lambda d: bfv.add(
            ctx, ct1.replace(data=d), ct2).data, ct1.data, hi=20005, lo=1005))
        chains.append(KeyedChain("keygen", lambda k, c: fold_u32(
            bfv.keygen(ctx, jrandom.fold_in(k, c))[0].data), hi=305, lo=15))
        return chains

    def g_k8():
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")
            params8 = make_scheme_params(
                SecurityParams(poly_degree=n, log_q=218, hamming_weight=64))
        assert params8.k == 8
        fhe8 = FHE(params8, seed=2)
        pk8, sk8 = fhe8.keygen()
        rlk8 = fhe8.relinkey_gen(sk8)
        c8a = fhe8.encrypt(fhe8.encode([5, 10]), pk8)
        c8b = fhe8.encrypt(fhe8.encode([3, 6]), pk8)
        got8 = fhe8.decode(fhe8.decrypt(fhe8.multiply(c8a, c8b, rlk8), sk8))
        assert list(got8[:2]) == [15, 60], got8[:2]
        chains = [
            Chain("mul_k8", lambda a: bfv.multiply(
                fhe8.ctx, c8a.replace(data=a), c8b, rlk8).data,
                c8a.data, hi=85, lo=5),
            Chain("tens_k8", lambda a: bfv.multiply_no_relin(
                fhe8.ctx, c8a.replace(data=a), c8b).data[:, :2],
                c8a.data, hi=85, lo=5),
        ]
        hoist_elems = env.get(
            "hoist_elems", tuple(pow(3, s, 2 * n) for s in range(1, 9)))
        gk8 = fhe8.galoiskey_gen(sk8, elements=hoist_elems)
        p3_8 = fhe8.ctx.ntt_q.p[:, None, None]
        chains.append(Chain("rot_k8", lambda a: bfv.apply_galois(
            fhe8.ctx, c8a.replace(data=a), hoist_elems[0], gk8).data,
            c8a.data, hi=255, lo=15))

        def rot_hoist8_step(a):
            outs = bfv.apply_galois_hoisted(
                fhe8.ctx, c8a.replace(data=a), hoist_elems, gk8)
            return mmx.add_mod_tree(jnp.stack([o.data for o in outs]),
                                    p3_8[None], axis=0)[0]

        chains.append(Chain("rot_hoist_k8", rot_hoist8_step, c8a.data,
                            hi=45, lo=5, div=8.0))

        # k=8 batched hoisted rotations: 4 independent cts x 8 hoisted
        # rotations each
        def rot_hoist8_b4_step(a_st):
            outs = bfv.apply_galois_hoisted_batch(
                fhe8.ctx, [c8a.replace(data=a_st[i]) for i in range(4)],
                hoist_elems, gk8)
            return jnp.stack([
                mmx.add_mod_tree(jnp.stack([o.data for o in outs_i]),
                                 p3_8[None], axis=0)[0]
                for outs_i in outs])

        chains.append(Chain(
            "rot_hoist_k8_b4", rot_hoist8_b4_step,
            jnp.stack([c8a.data] * 4), hi=13, lo=1, div=32.0))
        return chains

    def g_k8_omega():
        """Grouped-gadget key switch (SecurityParams.ks_omega=2): half the
        digit NTTs and key inner products per key switch — the k=8
        relinearization lever (~27 extra bits of key-switch noise).  Sampled
        in the same round-robin as g_k8's omega=1 chains, so the A/B is
        interleaved within one run — the runner merges this group with
        g_k8 below."""
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")
            params8w = make_scheme_params(SecurityParams(
                poly_degree=n, log_q=218, hamming_weight=64, ks_omega=2))
        fhe8w = FHE(params8w, seed=2)
        pk8, sk8 = fhe8w.keygen()
        rlk8 = fhe8w.relinkey_gen(sk8)
        c8a = fhe8w.encrypt(fhe8w.encode([5, 10]), pk8)
        c8b = fhe8w.encrypt(fhe8w.encode([3, 6]), pk8)
        got8 = fhe8w.decode(fhe8w.decrypt(fhe8w.multiply(c8a, c8b, rlk8),
                                          sk8))
        assert list(got8[:2]) == [15, 60], got8[:2]
        hoist_elems = env.get(
            "hoist_elems", tuple(pow(3, s, 2 * n) for s in range(1, 9)))
        gk8 = fhe8w.galoiskey_gen(sk8, elements=hoist_elems)
        got_r = fhe8w.decode(fhe8w.decrypt(
            fhe8w.rotate_rows(c8a, 1, gk8), sk8))
        assert list(got_r[:1]) == [10], got_r[:2]
        chains = [
            Chain("mul_k8_w2", lambda a: bfv.multiply(
                fhe8w.ctx, c8a.replace(data=a), c8b, rlk8).data,
                c8a.data, hi=85, lo=5),
            Chain("rot_k8_w2", lambda a: bfv.apply_galois(
                fhe8w.ctx, c8a.replace(data=a), hoist_elems[0],
                gk8).data, c8a.data, hi=255, lo=15),
        ]
        p3_8w = fhe8w.ctx.ntt_q.p[:, None, None]

        def rot_hoist8w_step(a):
            outs = bfv.apply_galois_hoisted(
                fhe8w.ctx, c8a.replace(data=a), hoist_elems, gk8)
            return mmx.add_mod_tree(jnp.stack([o.data for o in outs]),
                                    p3_8w[None], axis=0)[0]

        chains.append(Chain("rot_hoist_k8_w2", rot_hoist8w_step, c8a.data,
                            hi=45, lo=5, div=8.0))
        return chains

    def g_n16384():
        fhe16 = FHE(make_scheme_params(SecurityParams(
            poly_degree=16384, log_q=90, hamming_weight=64)), seed=4)
        pk16, sk16 = fhe16.keygen()
        rlk16 = fhe16.relinkey_gen(sk16)
        a16 = fhe16.encrypt(fhe16.encode([5, 10]), pk16)
        b16 = fhe16.encrypt(fhe16.encode([3, 6]), pk16)
        got16m = fhe16.decode(fhe16.decrypt(
            fhe16.multiply(a16, b16, rlk16), sk16))
        assert list(got16m[:2]) == [15, 60], got16m[:2]
        ctx16 = fhe16.ctx
        chains = [Chain("mul_n16384", lambda a: bfv.multiply(
            ctx16, a16.replace(data=a), b16, rlk16).data,
            a16.data, hi=85, lo=5)]

        chains.append(Chain(
            "ntt_n16384", lambda x: _ntt.ntt_forward(x, ctx16.ntt_q),
            a16.data[:, :1, :], hi=1505, lo=55))

        # grouped-gadget variant (ks_omega=2 at k=3: kd=2): relin's digit
        # NTTs drop 9 -> 6 rows
        fhe16w = FHE(make_scheme_params(SecurityParams(
            poly_degree=16384, log_q=90, hamming_weight=64, ks_omega=2)),
            seed=4)
        pkw, skw = fhe16w.keygen()
        rlkw = fhe16w.relinkey_gen(skw)
        aw = fhe16w.encrypt(fhe16w.encode([5, 10]), pkw)
        bw = fhe16w.encrypt(fhe16w.encode([3, 6]), pkw)
        gotw = fhe16w.decode(fhe16w.decrypt(fhe16w.multiply(aw, bw, rlkw),
                                            skw))
        assert list(gotw[:2]) == [15, 60], gotw[:2]
        chains.append(Chain("mul_n16384_w2", lambda a: bfv.multiply(
            fhe16w.ctx, aw.replace(data=a), bw, rlkw).data,
            aw.data, hi=85, lo=5))
        return chains

    def g_bgv():
        from fhe_jax.scheme import bgv as _bgv
        bfhe = FHE(env["params"], seed=1, scheme="bgv")
        bpk, bsk = bfhe.keygen()
        brlk = bfhe.relinkey_gen(bsk)
        bct1 = bfhe.encrypt(bfhe.encode([5, 10, 15, 20]), bpk)
        bct2 = bfhe.encrypt(bfhe.encode([3, 6, 9, 12]), bpk)
        bgot = bfhe.decode(bfhe.decrypt(bfhe.multiply(bct1, bct2, brlk), bsk))
        assert list(bgot[:4]) == [15, 60, 135, 240], bgot[:4]
        return [Chain("bgv_mul", lambda a: _bgv.multiply(
            bfhe.ctx, bct1.replace(data=a), bct2, brlk).data,
            bct1.data, hi=305, lo=20)]

    def g_bootstrap():
        from fhe_jax.scheme import bootstrap as _bs
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")
            params_bs = make_scheme_params(SecurityParams(
                poly_degree=1024, log_q=120, lambda_=0, hamming_weight=16))
        fhe_bs = FHE(params_bs, seed=5)
        pk_bs, sk_bs = fhe_bs.keygen()
        kb = jrandom.PRNGKey(77)
        bsk_keys = _bs.make_bootstrap_key(
            fhe_bs.ctx, jrandom.fold_in(kb, 0), sk_bs, 0)
        ks_keys = _bs.keyswitch_keygen(
            fhe_bs.ctx, jrandom.fold_in(kb, 1), sk_bs, sk_bs)
        ct_bit = fhe_bs.encrypt(fhe_bs.encode_coeff([1]), pk_bs)

        # keys ride as jit ARGUMENTS: closed-over they would be baked into
        # the HLO as ~0.5 GB of constants
        def boot(ct_data, bsk, ksk):
            return _bs.bootstrap_binary(
                fhe_bs.ctx, jrandom.fold_in(kb, 2),
                ct_bit.replace(data=ct_data), sk_bs, bsk=bsk,
                ks_keys=ksk).data

        boot_j = jax.jit(boot)
        out_bit = boot_j(ct_bit.data, bsk_keys, ks_keys)
        got_bit = fhe_bs.decode_coeff(fhe_bs.decrypt(
            ct_bit.replace(data=out_bit), sk_bs))[0]
        assert got_bit == 1, got_bit
        _hard_sync(out_bit)
        boot_times = []
        for _ in range(5):
            t0 = time.perf_counter()
            r = boot_j(ct_bit.data, bsk_keys, ks_keys)
            jax.block_until_ready(r)
            boot_times.append(time.perf_counter() - t0)
            _hard_sync(r)
        bench.manual["bootstrap_ms_n1024"] = _rnd(
            _median(boot_times) * 1e3, 3)

        cts_bits = [fhe_bs.encrypt(fhe_bs.encode_coeff([i % 2]), pk_bs)
                    for i in range(8)]

        def boot_b8(ct_datas, bsk, ksk):
            outs = _bs.bootstrap_binary_batch(
                fhe_bs.ctx, [c.replace(data=d) for c, d in
                             zip(cts_bits, ct_datas)], bsk, ksk)
            return jnp.stack([o.data for o in outs])

        boot_b8_j = jax.jit(boot_b8)
        datas8 = [c.data for c in cts_bits]
        out_b8 = boot_b8_j(datas8, bsk_keys, ks_keys)
        for i in range(8):
            gb = fhe_bs.decode_coeff(fhe_bs.decrypt(
                cts_bits[i].replace(data=out_b8[i]), sk_bs))[0]
            assert gb == i % 2, (i, gb)
        _hard_sync(out_b8)
        boot8_times = []
        for _ in range(5):
            t0 = time.perf_counter()
            r = boot_b8_j(datas8, bsk_keys, ks_keys)
            jax.block_until_ready(r)
            boot8_times.append(time.perf_counter() - t0)
            _hard_sync(r)
        bench.manual["bootstrap_ms_n1024_b8"] = _rnd(
            _median(boot8_times) / 8.0 * 1e3, 3)

        rows_ep = bsk_keys.pos[0]
        acc0 = jnp.concatenate(
            [ct_bit.data[:, :1], ct_bit.data[:, 1:]], axis=1)
        return [Chain("ext_prod", lambda acc: _bs._external_product(
            fhe_bs.ctx, acc, rows_ep, 0), acc0, hi=2005, lo=105)]

    def g_mxu():
        from fhe_jax.ops import ntt_mxu as _nmxu
        fhe_mxu = FHE(env["params"], seed=0, use_mxu=True)
        mtb = fhe_mxu.ctx.ntt_q_mxu
        one_poly = env["ct1"].data[:, :1, :]
        big64 = jnp.tile(one_poly, (1, 64, 1))
        chains = [
            Chain("ntt_mxu", lambda x: _nmxu.ntt_forward(x, mtb),
                  one_poly, hi=1005, lo=55),
            Chain("ntt_mxu_b64", lambda x: _nmxu.ntt_forward(x, mtb),
                  big64, hi=105, lo=5, div=64.0),
        ]
        pk_m, sk_m = fhe_mxu.keygen()
        rlk_m = fhe_mxu.relinkey_gen(sk_m)
        c1m = fhe_mxu.encrypt(fhe_mxu.encode([5, 10, 15, 20]), pk_m)
        c2m = fhe_mxu.encrypt(fhe_mxu.encode([3, 6, 9, 12]), pk_m)
        got_m = fhe_mxu.decode(fhe_mxu.decrypt(
            fhe_mxu.multiply(c1m, c2m, rlk_m), sk_m))
        assert list(got_m[:4]) == [15, 60, 135, 240], got_m[:4]
        chains.append(Chain("mul_mxu", lambda a: bfv.multiply(
            fhe_mxu.ctx, c1m.replace(data=a), c2m, rlk_m).data,
            c1m.data, hi=85, lo=5))
        return chains

    def g_n32768():
        ps32 = _primes.find_ntt_primes(32768, 3)
        tb32 = _ntt.build_tables(32768, ps32)
        x32 = jnp.asarray(np.stack([
            np.random.default_rng(5).integers(
                0, p, (1, 32768), dtype=np.uint32) for p in ps32]))
        fwd32 = jax.jit(_ntt.ntt_forward)
        got32 = np.asarray(fwd32(x32, tb32))
        want0 = oracle.ntt_forward([int(v) for v in np.asarray(x32)[0, 0]],
                                   oracle.build_ntt_tables(32768, ps32[0]))
        assert got32[0, 0].tolist() == want0, "n=32768 NTT mismatch vs oracle"
        return [Chain("ntt_n32768", lambda x: _ntt.ntt_forward(x, tb32),
                      x32, hi=755, lo=55)]

    def g_k8_all():
        """k8 omega=1 and omega=2 chains in ONE round-robin (interleaved
        A/B — see g_k8_omega's docstring)."""
        return g_k8() + g_k8_omega()

    groups = [
        ("headline", g_headline),       # prints the first valid line
        ("mul_variants", g_mul_variants),
        ("ntt", g_ntt),
        ("rotations", g_rotations),
        ("residency", g_residency),
        ("k8", g_k8_all),
        ("n16384", g_n16384),
        ("bootstrap", g_bootstrap),
        ("enc_dec", g_enc_dec),
        ("bgv", g_bgv),
        ("mxu", g_mxu),
        ("n32768", g_n32768),
    ]
    only = os.environ.get("FHE_BENCH_GROUPS")
    if only:
        keep = {"headline"} | set(only.split(","))
        groups = [(nm, fn) for nm, fn in groups if nm in keep]
    done = []
    bench.aux["groups_done"] = done
    for name, builder in groups:
        if done and _elapsed() > BUDGET_S:
            print(f"# budget: skipping group '{name}' "
                  f"(elapsed {_elapsed():.0f}s > {BUDGET_S:.0f}s)",
                  flush=True)
            continue
        try:
            t_build = time.time()
            chains = builder()
            print(f"# group {name}: build {time.time() - t_build:.1f}s",
                  flush=True)
            if chains:
                bench.merge(run_rounds(chains))
            done.append(name)
            # free this group's chains/closures/jit executables before the
            # next context builds: 13 groups of baked-constant executables
            # accumulated to an HBM RESOURCE_EXHAUSTED on the tail groups
            # (bootstrap's 0.5 GB key argument was the straw)
            del chains
            import gc
            gc.collect()
        except Exception as e:  # crash-isolate: one bad group (OOM, failed
            # golden check) must not kill the numbers already measured —
            # the headline group alone is NOT guarded (its correctness gate
            # failing should fail the bench)
            if not done:
                raise
            import traceback
            traceback.print_exc()
            print(f"# group '{name}' failed: {type(e).__name__}: {e}",
                  flush=True)
        bench.emit()


if __name__ == "__main__":
    main()
