#!/usr/bin/env python3
"""Prove that the library's main path runs on one NVIDIA GPU, bit for bit.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One card, in order (any failed check raises and exits non-zero):

  1. device     JAX's default backend must be a GPU; prints the card's
                name and power limit (nvidia-smi), device_kind, device
                count and the JAX/jaxlib versions.
  2. main path  Through ``FHE``: BFV at n=8192, log_q=210 (k=7, 128-bit
                secure) and at the headline n=8192, log_q=90 (k=3): keygen,
                relin and Galois keys, encode/encrypt of full random slot
                vectors, add, multiply+relin, rotate_rows, hoisted rotations,
                sum_slots, mod switch + level-1 multiply, decrypt/decode,
                each checked against the same slot arithmetic mod t in
                numpy; BGV multiply and rotate at k=3; multiply_batch B=8.
  3. reference  Plain-reference comparisons with tolerance 0 (all uint32
                integer arithmetic): NTT forward/inverse for all 7 primes
                against ``oracle``; BEHZ multiply_no_relin at k=3 against
                ``oracle.behz_multiply_no_relin``; multiply+relin,
                apply_galois and decrypt on the GPU against the same jitted
                functions on this process's CPU backend; the four-step
                matmul polymul against the stage-sweep polymul.
  4. bootstrap  bootstrap_binary and bootstrap_lut at n=1024, lambda_=0 —
                the only size the repo supports; a smoke check, NOT a
                secure deployment.
  5. times      Medians of ~50 jitted calls after warm-up (information, not
                a benchmark), named with the card and its power limit.

``--four-cards`` runs only ``__graft_entry__.dryrun_multichip`` at n=8192,
log_q=120 (k=4, one prime per card): rns-sharded multiply, the explicit
shard_map multiply, the coefficient-sharded multiply and the dp-sharded
batched multiply, each bit-exact with the single-card multiply and
decrypt-checked.

The last stdout line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import jax
import jaxlib
import jax.numpy as jnp
import jax.random as jrandom

from fhe_jax import FHE, oracle
from fhe_jax.ops import ntt as _ntt
from fhe_jax.ops import ntt_mxu as _ntt_mxu
from fhe_jax.ops import rns as _rns
from fhe_jax.params import SecurityParams, make_scheme_params, security_margin
from fhe_jax.scheme import bfv
from fhe_jax.utils import compile_cache, device_report

N = 8192
LOG_Q_SECURE = 210      # k=7 x 30-bit primes: the largest whole count <= 218
LOG_Q_HEADLINE = 90     # k=3, bench.py's headline context
HAMMING_WEIGHT = 64
HOIST_STEPS = tuple(range(1, 9))


T_START = time.perf_counter()


def check(name: str, ok: bool, detail: str = "") -> None:
    """Raise on a failed check; print passed ones with the time since start
    (compilation included), so a slow step shows where it is."""
    if not ok:
        raise AssertionError(f"FAILED {name} {detail}".rstrip())
    print(f"  ok  {name}  [{time.perf_counter() - T_START:.1f}s]", flush=True)


def check_slots(name: str, got, want, t: int) -> None:
    got = np.asarray(got, dtype=np.int64)
    want = np.asarray(want, dtype=np.int64) % t
    bad = np.flatnonzero(got != want)
    check(name, bad.size == 0,
          f"{bad.size} slots differ, first at {bad[:4].tolist()}")


def check_equal(name: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    same = got.shape == want.shape and np.array_equal(got, want)
    check(name, same, f"shape {got.shape} vs {want.shape}, "
          f"{int(np.sum(got != want)) if got.shape == want.shape else '-'} "
          "elements differ")


def rotate_slots(v: np.ndarray, steps: int) -> np.ndarray:
    """Slot model of rotate_rows: each row of the 2 x n/2 matrix rolls left."""
    rows = v.reshape(2, -1)
    return np.roll(rows, -steps, axis=1).reshape(-1)


def make_fhe(n: int, log_q: int, scheme: str = "bfv", seed: int = 0,
             hamming_weight: int = HAMMING_WEIGHT, **security_kw) -> FHE:
    params = make_scheme_params(SecurityParams(
        poly_degree=n, log_q=log_q, hamming_weight=hamming_weight,
        **security_kw))
    return FHE(params, seed=seed, scheme=scheme)


# ---------------------------------------------------------------------------
# phase 2: the main path through FHE
# ---------------------------------------------------------------------------


def main_path(fhe: FHE, label: str, rng: np.random.Generator) -> dict:
    """Every main-path op once, each decrypted and checked against numpy
    slot arithmetic mod t.  Returns the keys and ciphertexts for reuse."""
    p = fhe.params
    n, t = p.n, p.t
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk)
    a = rng.integers(0, t, n)
    b = rng.integers(0, t, n)
    ca = fhe.encrypt(fhe.encode(a), pk)
    cb = fhe.encrypt(fhe.encode(b), pk)

    def dec(ct):
        return fhe.decode(fhe.decrypt(ct, sk))

    check_slots(f"{label} encrypt/decrypt", dec(ca), a, t)
    check_slots(f"{label} add", dec(fhe.add(ca, cb)), a + b, t)
    prod = fhe.multiply(ca, cb, rlk)
    check_slots(f"{label} multiply+relin", dec(prod), a * b, t)
    check_slots(f"{label} rotate_rows(1)", dec(fhe.rotate_rows(ca, 1, gk)),
                rotate_slots(a, 1), t)
    gk_h = fhe.galoiskey_gen(
        sk, elements=[pow(3, s, 2 * n) for s in HOIST_STEPS])
    outs = fhe.rotate_rows_hoisted(ca, HOIST_STEPS, gk_h)
    check(f"{label} rotate_rows_hoisted count", len(outs) == len(HOIST_STEPS))
    for s, o in zip(HOIST_STEPS, outs):
        check_slots(f"{label} rotate_rows_hoisted({s})", dec(o),
                    rotate_slots(a, s), t)
    check_slots(f"{label} sum_slots", dec(fhe.sum_slots(ca, gk)),
                np.full(n, a.sum()), t)
    ca1 = fhe.mod_switch_to_next(ca)
    cb1 = fhe.mod_switch_to_next(cb)
    check(f"{label} mod_switch_to_next level", ca1.level == 1)
    check_slots(f"{label} level-1 multiply", dec(fhe.multiply(ca1, cb1, rlk)),
                a * b, t)
    return dict(pk=pk, sk=sk, rlk=rlk, gk=gk, ca=ca, cb=cb, a=a, b=b)


def bgv_path(rng: np.random.Generator) -> None:
    fhe = make_fhe(N, LOG_Q_HEADLINE, scheme="bgv", seed=1)
    t = fhe.params.t
    pk, sk = fhe.keygen()
    rlk = fhe.relinkey_gen(sk)
    gk = fhe.galoiskey_gen(sk, elements=[pow(3, 1, 2 * N)])
    a = rng.integers(0, t, N)
    b = rng.integers(0, t, N)
    ca = fhe.encrypt(fhe.encode(a), pk)
    cb = fhe.encrypt(fhe.encode(b), pk)
    check_slots("bgv k=3 multiply+relin",
                fhe.decode(fhe.decrypt(fhe.multiply(ca, cb, rlk), sk)),
                a * b, t)
    check_slots("bgv k=3 rotate_rows(1)",
                fhe.decode(fhe.decrypt(fhe.rotate_rows(ca, 1, gk), sk)),
                rotate_slots(a, 1), t)


def batch_path(fhe: FHE, st: dict, rng: np.random.Generator, B: int = 8):
    t = fhe.params.t
    xs = [rng.integers(0, t, N) for _ in range(B)]
    ys = [rng.integers(0, t, N) for _ in range(B)]
    cxs = fhe.encrypt_batch([fhe.encode(x) for x in xs], st["pk"])
    cys = fhe.encrypt_batch([fhe.encode(y) for y in ys], st["pk"])
    outs = fhe.multiply_batch(cxs, cys, st["rlk"])
    for i in range(B):
        check_slots(f"k=3 multiply_batch[{i}] (B={B})",
                    fhe.decode(fhe.decrypt(outs[i], st["sk"])),
                    xs[i] * ys[i], t)
    check_equal("k=3 multiply_batch[3] == multiply",
                outs[3].data, fhe.multiply(cxs[3], cys[3], st["rlk"]).data)


# ---------------------------------------------------------------------------
# phase 3: the plain reference, bit for bit
# ---------------------------------------------------------------------------


def reference_ntt(fhe7: FHE, rng: np.random.Generator) -> None:
    primes = fhe7.params.q_primes
    tb = fhe7.ctx.ntt_q
    x = np.stack([rng.integers(0, p, (1, N)) for p in primes]
                 ).astype(np.uint32)
    fwd = np.asarray(jax.jit(_ntt.ntt_forward)(jnp.asarray(x), tb))
    inv = np.asarray(jax.jit(_ntt.ntt_inverse)(jnp.asarray(x), tb))
    for i, p in enumerate(primes):
        otb = oracle.build_ntt_tables(N, int(p))
        row = [int(v) for v in x[i, 0]]
        check_equal(f"ntt_forward n={N} prime {i} vs oracle",
                    fwd[i, 0], np.array(oracle.ntt_forward(row, otb),
                                        dtype=np.uint32))
        check_equal(f"ntt_inverse n={N} prime {i} vs oracle",
                    inv[i, 0], np.array(oracle.ntt_inverse(row, otb),
                                        dtype=np.uint32))


def reference_behz(fhe3: FHE, st: dict) -> None:
    params = fhe3.params

    def to_bigint(ct):
        d = np.asarray(ct.data)
        return [_rns.from_rns_host(d[:, c, :], params.q_primes)
                for c in range(d.shape[1])]

    got = jax.jit(bfv.multiply_no_relin)(fhe3.ctx, st["ca"], st["cb"])
    want = oracle.behz_multiply_no_relin(
        params, to_bigint(st["ca"]), to_bigint(st["cb"]))
    check("multiply_no_relin k=3 vs oracle.behz_multiply_no_relin",
          to_bigint(got) == want)


def reference_cpu_backend(fhe3: FHE, st: dict) -> None:
    """The same jitted functions on the GPU and on the CPU backend."""
    cpu = jax.devices("cpu")[0]
    ctx = fhe3.ctx
    g = pow(3, 1, 2 * N)
    ops = {
        "multiply+relin": (jax.jit(bfv.multiply),
                           (ctx, st["ca"], st["cb"], st["rlk"])),
        "apply_galois": (jax.jit(lambda c, x, k: bfv.apply_galois(c, x, g, k)),
                         (ctx, st["ca"], st["gk"])),
        "decrypt": (jax.jit(bfv.decrypt), (ctx, st["ca"], st["sk"])),
    }
    for name, (fn, args) in ops.items():
        on_gpu = np.asarray(fn(*args).data)
        with jax.default_device(cpu):
            on_cpu = fn(*jax.device_put(args, cpu))
        check(f"{name} ran on cpu", on_cpu.data.devices() == {cpu})
        check_equal(f"{name} k=3 gpu vs cpu backend", on_gpu,
                    np.asarray(on_cpu.data))


def reference_mxu(fhe3: FHE, rng: np.random.Generator) -> None:
    primes = fhe3.params.q_primes
    x, y = (jnp.asarray(np.stack([rng.integers(0, p, (2, N)) for p in primes]
                                 ).astype(np.uint32)) for _ in range(2))
    tbm = _ntt_mxu.build_mxu_tables(N, primes)
    got = jax.jit(_ntt_mxu.polymul_negacyclic)(x, y, tbm)
    want = jax.jit(_ntt.polymul_negacyclic)(x, y, fhe3.ctx.ntt_q)
    check_equal("ntt_mxu.polymul_negacyclic vs ntt.polymul_negacyclic", got,
                want)


# ---------------------------------------------------------------------------
# phase 4: bootstrap smoke (toy parameters)
# ---------------------------------------------------------------------------


def bootstrap_path(n: int = 1024) -> None:
    print(f"bootstrap: n={n}, log_q=120, lambda_=0 — a smoke check of the "
          "pipeline, NOT a secure deployment", flush=True)
    fhe = make_fhe(n, 120, seed=5, lambda_=0, hamming_weight=16)
    pk, sk = fhe.keygen()
    bsk = fhe.make_bootstrap_key(sk)
    for bit in (0, 1):
        ct = fhe.encrypt(fhe.encode_coeff([bit]), pk)
        out = fhe.bootstrap_binary(ct, sk, bsk)
        check(f"bootstrap_binary({bit})",
              int(fhe.decode_coeff(fhe.decrypt(out, sk))[0]) == bit)
    lut = [(m * m + 3) % 7 for m in range(4)]
    for m in (1, 3):
        ct = fhe.encrypt(fhe.encode_coeff([m]), pk)
        out = fhe.bootstrap_lut(ct, lut, sk, bsk)
        got = int(fhe.decode_coeff(fhe.decrypt(out, sk))[0])
        check(f"bootstrap_lut({m}) -> lut[{m}]={lut[m]}", got == lut[m],
              f"got {got}")


# ---------------------------------------------------------------------------
# phase 5: wall times
# ---------------------------------------------------------------------------


def median_ms(fn, *args, iters: int = 50) -> float:
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def wall_times(fhe3: FHE, st3: dict, fhe7: FHE, st7: dict) -> dict:
    ctx = fhe3.ctx
    mul = jax.jit(bfv.multiply)
    rot = jax.jit(lambda c, x, k: bfv.rotate_rows(c, x, 1, k))
    pt = fhe3.encode(st3["a"])
    return {
        "multiply_relin_k3_ms": median_ms(mul, ctx, st3["ca"], st3["cb"],
                                          st3["rlk"]),
        "multiply_relin_k7_ms": median_ms(mul, fhe7.ctx, st7["ca"],
                                          st7["cb"], st7["rlk"]),
        "rotate_rows_k3_ms": median_ms(rot, ctx, st3["ca"], st3["gk"]),
        "encrypt_k3_ms": median_ms(jax.jit(bfv.encrypt), ctx,
                                   jrandom.PRNGKey(1), st3["pk"], pt),
        "decrypt_k3_ms": median_ms(jax.jit(bfv.decrypt), ctx, st3["ca"],
                                   st3["sk"]),
    }


# ---------------------------------------------------------------------------


def device_phase() -> dict:
    dev = device_report.require_gpu()
    print(dev["nvidia_smi"], flush=True)
    cards = " / ".join(dev["nvidia_smi"].splitlines())
    print(f"device: {cards} | device_kind={dev['kind']} "
          f"count={dev['count']} | jax {jax.__version__} "
          f"jaxlib {jaxlib.__version__}", flush=True)
    return dev


def run_one_card(dev: dict) -> None:
    rng = np.random.default_rng(2026)
    t0 = time.perf_counter()
    print("phase main path", flush=True)
    fhe7 = make_fhe(N, LOG_Q_SECURE, seed=7)
    margin = security_margin(fhe7.params.security)
    check("k=7 context (210 bits, 128-bit secure)",
          fhe7.params.k == 7 and margin is not None and margin >= 0,
          f"k={fhe7.params.k}, margin={margin}")
    st7 = main_path(fhe7, "bfv k=7", rng)
    fhe3 = make_fhe(N, LOG_Q_HEADLINE, seed=3)
    check("k=3 context", fhe3.params.k == 3)
    st3 = main_path(fhe3, "bfv k=3", rng)
    bgv_path(rng)
    batch_path(fhe3, st3, rng)
    print(f"phase main path done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    print("phase reference (tolerance 0)", flush=True)
    reference_ntt(fhe7, rng)
    reference_behz(fhe3, st3)
    reference_cpu_backend(fhe3, st3)
    reference_mxu(fhe3, rng)
    print(f"phase reference done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    print("phase bootstrap", flush=True)
    bootstrap_path()
    print(f"phase bootstrap done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    times = wall_times(fhe3, st3, fhe7, st7)
    card = dev["cards"][0] if dev["cards"] else {"name": dev["nvidia_smi"],
                                                 "power_limit": "unknown"}
    print(f"wall times (median of 50 jitted calls after warm-up, "
          f"{card['name']}, power limit {card['power_limit']}): "
          + ", ".join(f"{k}={v:.4f}" for k, v in times.items()), flush=True)


def run_four_cards() -> None:
    import __graft_entry__

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, "
                           f"found {len(jax.devices())}")
    __graft_entry__.dryrun_multichip(4, n_poly=N,
                                     hamming_weight=HAMMING_WEIGHT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args()
    compile_cache.configure()
    dev = device_phase()
    if args.four_cards:
        run_four_cards()
    else:
        run_one_card(dev)
    devices = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
