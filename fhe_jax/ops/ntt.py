"""Negacyclic NTT over RNS prime stacks — the stage-sweep NTT engine.

Replaces the reference's NTT stack (SURVEY.md §2.3-2.5):
  * ``NTTEngine`` / ``RNS_NTTEngine`` host classes (``include/ntt.cuh:72-137``)
    become a precomputed-constants pytree (``NTTTables``) + pure jitted
    functions — one trace handles every prime at once instead of one CUDA
    stream per prime (``src/ntt.cu:137-141``).
  * ``ntt_forward_optimized_kernel`` / ``ntt_inverse_optimized_kernel``
    (``kernels/ntt_kernels.cu:7-121``) become vectorized stage sweeps over a
    ``[k, batch, n]`` tensor: every stage is a full-width elementwise op
    over the batch and prime axes, and there is **no bit-reverse pass**
    (merged-psi CT forward emits bit-reversed order, GS inverse consumes it —
    the property the reference's Stockham variant was chasing, reference
    ``docs/NTT_OPTIMIZATION.md:41-49``).
  * Butterfly modmuls use Harvey/Shoup precomputed-quotient multiplication
    (see ops/modmath.py) instead of 4x4-limb Montgomery CIOS.

Layout convention: residue tensors are ``[k, batch, n]`` uint32, prime-major
(k leading) so the prime axis shards across devices (SURVEY.md §2 parallelism
table: "one CUDA stream per prime" -> "shard the prime axis").

The algorithm is bit-exact with ``fhe_jax.oracle.ntt_forward/ntt_inverse``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import primes as _primes
from . import modmath as mm


class NTTTables(NamedTuple):
    """Precomputed per-prime constants; a pytree of uint32 arrays.

    Shapes: tables are [k, n]; scalars are [k]. For a single prime, k == 1.
    """

    p: jax.Array            # [k] primes
    mu: jax.Array           # [k] Barrett constants floor(2^61/p)
    psi_br: jax.Array       # [k, n] psi^brv(i)
    psi_br_shoup: jax.Array
    ipsi_br: jax.Array      # [k, n] psi^-brv(i)
    ipsi_br_shoup: jax.Array
    n_inv: jax.Array        # [k]
    n_inv_shoup: jax.Array

    @property
    def k(self) -> int:
        return self.p.shape[0]

    @property
    def n(self) -> int:
        return self.psi_br.shape[-1]


@functools.lru_cache(maxsize=None)
def _build_tables_np(n: int, prime_tuple: tuple[int, ...]):
    """Host-side table build (exact Python ints -> numpy uint32).

    Uses the native C++ builder (``native/fhecore.cpp:fhe_build_ntt_tables``)
    when available; the Python body below is the bit-identical fallback."""
    from ..utils import native as _native

    bits = n.bit_length() - 1
    rows = {f: [] for f in NTTTables._fields}
    pending = []  # primes the native path could not handle
    for p in prime_tuple:
        fast = _native.build_ntt_tables(n, p)
        if fast is None:
            pending.append(p)
            continue
        psi_br, psi_sh, ipsi_br, ipsi_sh, n_inv, n_inv_sh = fast
        rows["p"].append(p)
        rows["mu"].append(
            mm.barrett_precompute(p) if (1 << 29) < p < (1 << 30) else 0)
        rows["psi_br"].append(psi_br)
        rows["psi_br_shoup"].append(psi_sh)
        rows["ipsi_br"].append(ipsi_br)
        rows["ipsi_br_shoup"].append(ipsi_sh)
        rows["n_inv"].append(n_inv)
        rows["n_inv_shoup"].append(n_inv_sh)
    if pending and rows["p"]:
        # mixed native/python would break ordering; redo everything in python
        rows = {f: [] for f in NTTTables._fields}
        pending = list(prime_tuple)
    elif not pending:
        return {
            "p": np.array(rows["p"], dtype=np.uint32),
            "mu": np.array(rows["mu"], dtype=np.uint32),
            "psi_br": np.stack(rows["psi_br"]),
            "psi_br_shoup": np.stack(rows["psi_br_shoup"]),
            "ipsi_br": np.stack(rows["ipsi_br"]),
            "ipsi_br_shoup": np.stack(rows["ipsi_br_shoup"]),
            "n_inv": np.array(rows["n_inv"], dtype=np.uint32),
            "n_inv_shoup": np.array(rows["n_inv_shoup"], dtype=np.uint32),
        }

    brv = np.array([_primes.bit_reverse(i, bits) for i in range(n)])
    for p in pending:
        psi = _primes.negacyclic_psi(n, p)
        ipsi = pow(psi, -1, p)
        pows = np.empty(n, dtype=object)
        ipows = np.empty(n, dtype=object)
        x = y = 1
        for i in range(n):
            pows[i] = x
            ipows[i] = y
            x = x * psi % p
            y = y * ipsi % p
        psi_br = pows[brv]
        ipsi_br = ipows[brv]
        n_inv = pow(n, -1, p)
        rows["p"].append(p)
        # Small primes (e.g. t = 65537 for the BatchEncoder's mod-t NTT) get
        # mu = 0: their transforms only use Shoup butterflies, never Barrett.
        rows["mu"].append(
            mm.barrett_precompute(p) if (1 << 29) < p < (1 << 30) else 0)
        rows["psi_br"].append(psi_br.astype(np.uint32))
        rows["psi_br_shoup"].append(
            np.array([mm.shoup_precompute(int(w), p) for w in psi_br], dtype=np.uint32))
        rows["ipsi_br"].append(ipsi_br.astype(np.uint32))
        rows["ipsi_br_shoup"].append(
            np.array([mm.shoup_precompute(int(w), p) for w in ipsi_br], dtype=np.uint32))
        rows["n_inv"].append(n_inv)
        rows["n_inv_shoup"].append(mm.shoup_precompute(n_inv, p))
    return {
        "p": np.array(rows["p"], dtype=np.uint32),
        "mu": np.array(rows["mu"], dtype=np.uint32),
        "psi_br": np.stack(rows["psi_br"]),
        "psi_br_shoup": np.stack(rows["psi_br_shoup"]),
        "ipsi_br": np.stack(rows["ipsi_br"]),
        "ipsi_br_shoup": np.stack(rows["ipsi_br_shoup"]),
        "n_inv": np.array(rows["n_inv"], dtype=np.uint32),
        "n_inv_shoup": np.array(rows["n_inv_shoup"], dtype=np.uint32),
    }


def build_tables(n: int, primes_list) -> NTTTables:
    """Build NTT tables for a list of primes (reference
    ``precompute_twiddle_factors``, ``src/ntt.cu:77-107`` — correct here)."""
    host = _build_tables_np(n, tuple(int(p) for p in primes_list))
    return NTTTables(**{k: jnp.asarray(v) for k, v in host.items()})


def slice_tables(tb: NTTTables, k: int) -> NTTTables:
    """First-k-primes view (for modulus-switched levels)."""
    return NTTTables(*(arr[:k] for arr in tb))


def slice_tables_last(tb: NTTTables, k: int) -> NTTTables:
    """Last-k-primes view.  The leveled BEHZ auxiliary base shrinks from the
    FRONT so that m_sk (always the last Bsk prime, the Shenoy-Kumaresan
    anchor) stays in every level's base — a suffix is still a zero-copy row
    slice."""
    return NTTTables(*(arr[-k:] for arr in tb))


def _bcast(tb_slice, k):
    """[k, m] twiddle slice -> [k, 1, m, 1] for [k, B, m, 2, t] data."""
    return tb_slice[:, None, :, None]


def ntt_forward(a: jax.Array, tb: NTTTables) -> jax.Array:
    """Forward negacyclic NTT, natural -> bit-reversed order.

    a: [k, batch, n] uint32 residues (k must match tb.k).
    Bit-exact with oracle.ntt_forward per (prime, batch) slice.
    """
    k, b, n = a.shape
    p4 = tb.p[:, None, None, None]
    m = 1
    while m < n:
        t = n // (2 * m)
        w = _bcast(jax.lax.slice_in_dim(tb.psi_br, m, 2 * m, axis=1), k)
        ws = _bcast(jax.lax.slice_in_dim(tb.psi_br_shoup, m, 2 * m, axis=1), k)
        x = a.reshape(k, b, m, 2, t)
        u = x[:, :, :, 0, :]
        v = mm.mul_mod_shoup(x[:, :, :, 1, :], w, ws, p4)
        a = jnp.stack(
            (mm.add_mod(u, v, p4), mm.sub_mod(u, v, p4)), axis=3
        ).reshape(k, b, n)
        m *= 2
    return a


def ntt_inverse(a: jax.Array, tb: NTTTables) -> jax.Array:
    """Inverse negacyclic NTT, bit-reversed -> natural order, including the
    n^-1 scaling (reference folds it into ``ntt_inverse_optimized_kernel``)."""
    k, b, n = a.shape
    p4 = tb.p[:, None, None, None]
    m = n // 2
    while m >= 1:
        t = n // (2 * m)
        w = _bcast(jax.lax.slice_in_dim(tb.ipsi_br, m, 2 * m, axis=1), k)
        ws = _bcast(jax.lax.slice_in_dim(tb.ipsi_br_shoup, m, 2 * m, axis=1), k)
        x = a.reshape(k, b, m, 2, t)
        u = x[:, :, :, 0, :]
        v = x[:, :, :, 1, :]
        a = jnp.stack(
            (
                mm.add_mod(u, v, p4),
                mm.mul_mod_shoup(mm.sub_mod(u, v, p4), w, ws, p4),
            ),
            axis=3,
        ).reshape(k, b, n)
        m //= 2
    p3 = tb.p[:, None, None]
    return mm.mul_mod_shoup(
        a, tb.n_inv[:, None, None], tb.n_inv_shoup[:, None, None], p3
    )


def pointwise_mul(a: jax.Array, b: jax.Array, tb: NTTTables) -> jax.Array:
    """Hadamard product in the NTT domain (reference
    ``ntt_pointwise_mul_kernel``, ``kernels/ntt_kernels.cu:124-137``)."""
    return mm.mul_mod_barrett(a, b, tb.p[:, None, None], tb.mu[:, None, None])


def polymul_negacyclic(a: jax.Array, b: jax.Array, tb: NTTTables) -> jax.Array:
    """Negacyclic polynomial product via NTT (reference ``NTTEngine::multiply``,
    ``src/ntt.cu:49-75``)."""
    return ntt_inverse(pointwise_mul(ntt_forward(a, tb), ntt_forward(b, tb), tb), tb)
