"""Scheme parameterization.

Counterpart of the reference's config layer:
  * ``SecurityParams``  — mirrors ``include/fhe.cuh:15-21`` field for field.
  * ``SchemeParams``    — mirrors ``include/fhe.cuh:24-39`` but is a frozen,
    hashable host-side *plan* (no device pointers): the big modulus q is never
    materialized on device; the RNS prime basis *is* the bigint layer
    (design decision 1 in SURVEY.md §7 — no u64 carry chains, so we
    use 30-bit word-size primes and lane-sliced uint32 arithmetic instead of
    the reference's 256-bit limbs + PTX carry chains).

Basis layout (BEHZ-style RNS-BFV, all-integer so it needs no f64):
  * q-basis   : k primes of 30 bits, p ≡ 1 (mod 2n)        (ciphertext modulus)
  * aux-basis : k more 30-bit NTT primes  B = {b_1..b_k}   (tensor-product headroom)
  * m_sk      : one more 30-bit NTT prime                  (Shenoy-Kumaresan anchor)
  * m_tilde   : 2**16                                      (exact base-conversion fix)
  * gamma     : 30-bit prime, not NTT-constrained          (exact RNS decryption)
"""

from __future__ import annotations

import dataclasses
import functools
import math

from . import primes as _primes

PRIME_BITS = 30  # All RNS primes live in (2**29, 2**30); see ops/modmath.py.
M_TILDE = 1 << 16


@dataclasses.dataclass(frozen=True)
class SecurityParams:
    """Security parameters (reference ``include/fhe.cuh:15-21``)."""

    lambda_: int = 128          # security level
    poly_degree: int = 4096     # n, power of two
    log_q: int = 120            # log2 of ciphertext modulus
    sigma: float = 3.2          # gaussian noise stddev
    hamming_weight: int = 64    # ternary secret-key weight
    # Plaintext modulus.  The reference carries t on SchemeParams
    # (include/fhe.cuh:24-39) and always sets 65537 (src/fhe.cu:14); we expose
    # it.  Requirements: prime, t ≡ 1 (mod 2n) for SIMD batching, and
    # 65537 <= t < 2^29 (the device decryption path centers 16-bit correction
    # terms against t, and every residue lane assumes t < q_i).
    plain_modulus: int = 65537
    # Key-switch gadget rank: omega primes per gadget digit (SEAL's
    # decomposition-base idea on the RNS basis).  omega=1 is the classic
    # per-prime gadget; omega=2 halves the digit count — half the digit
    # NTTs and key inner products per key switch (the k=8 relinearization
    # lever) — at the cost of ~PRIME_BITS*(omega-1) extra bits of
    # key-switch noise per operation.  Leveled key material derived by
    # switch_relin_keys/switch_galois_keys requires (k - level) % omega == 0
    # (whole gadget groups must survive a drop).
    ks_omega: int = 1


@dataclasses.dataclass(frozen=True)
class SchemeParams:
    """Derived scheme plan (reference ``include/fhe.cuh:24-39``, ``src/fhe.cu:7-40``).

    Unlike the reference this holds only Python ints/tuples, so it is hashable
    and can be a static argument to jitted functions.
    """

    security: SecurityParams
    n: int                       # polynomial degree
    t: int                       # plaintext modulus (prime, t ≡ 1 mod 2n; default 65537)
    q_primes: tuple[int, ...]    # RNS basis for q = prod(q_primes)
    aux_primes: tuple[int, ...]  # auxiliary basis B for BEHZ multiplication
    m_sk: int                    # Shenoy-Kumaresan extra prime
    gamma: int                   # decryption correction prime
    m_tilde: int = M_TILDE

    @property
    def q(self) -> int:
        return math.prod(self.q_primes)

    @property
    def delta(self) -> int:
        """Δ = floor(q/t) (reference ``src/fhe.cu:17`` computes ⌊q/t⌉; floor is
        the standard BFV choice and what our oracle uses)."""
        return self.q // self.t

    @property
    def k(self) -> int:
        return len(self.q_primes)

    @property
    def bsk_primes(self) -> tuple[int, ...]:
        """The extended basis Bsk = B ∪ {m_sk}."""
        return self.aux_primes + (self.m_sk,)

    @property
    def slot_count(self) -> int:
        """SIMD slots (reference ``src/fhe.cu:267-279``: slot_count = n/2)."""
        return self.n // 2

    def modulus_chain(self) -> tuple[int, ...]:
        """Modulus-switching chain q_L > q_{L-1} > ... (prefix products of q_primes),
        mirroring ``SchemeParams::modulus_chain`` (``include/fhe.cuh:38``)."""
        out = []
        q = 1
        for p in self.q_primes:
            q *= p
            out.append(q)
        return tuple(reversed(out))


# Maximum log2(q) for 128-bit classical security per polynomial degree
# (homomorphicencryption.org standard tables, ternary secret).  The reference
# documents the same rules in README "Security Considerations" /
# docs/ARCHITECTURE.md:527-539 but never enforces them; we warn.
_MAX_LOGQ_128 = {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438,
                 32768: 881}


def security_margin(security: SecurityParams) -> int | None:
    """max-secure log q minus the REALIZED modulus size at lambda=128
    (negative = parameters are below 128-bit security); None if n is
    off-table.  The realized modulus is k primes of PRIME_BITS each —
    ceil(log_q/30) rounded up, floored at 2 — which can exceed the
    requested log_q substantially."""
    cap = _MAX_LOGQ_128.get(security.poly_degree)
    if cap is None:
        return None
    k = max(2, math.ceil(security.log_q / PRIME_BITS))
    return cap - k * PRIME_BITS


@functools.lru_cache(maxsize=None)
def make_scheme_params(security: SecurityParams = SecurityParams()) -> SchemeParams:
    """Expand SecurityParams into a full plan (reference ``src/fhe.cu:7-40``).

    k = ceil(log_q / 30) primes of 30 bits each; the reference used 3x40-bit
    primes for log_q=120 (``src/fhe.cu:20-23``) — we use 4x30-bit because
    the device arithmetic is uint32 lanes.
    """
    n = security.poly_degree
    if n & (n - 1) or n < 8:
        raise ValueError("poly_degree must be a power of two >= 8")
    margin = security_margin(security)
    if margin is not None and margin < 0 and security.lambda_ >= 128:
        import warnings
        k_req = max(2, math.ceil(security.log_q / PRIME_BITS))
        warnings.warn(
            f"parameters (n={n}, log_q={security.log_q} -> realized "
            f"~{k_req * PRIME_BITS} bits over {k_req} primes) fall below "
            f"the requested {security.lambda_}-bit security level (max "
            f"log_q for n={n} is {_MAX_LOGQ_128[n]}); the reference's own "
            "default (n=4096, log_q=120) has the same issue — use n=8192 "
            "or a smaller modulus for production",
            stacklevel=2)
    t = security.plain_modulus
    if not (65537 <= t < (1 << 29)):
        raise ValueError(
            f"plain_modulus {t} out of range [65537, 2^29): the RNS layers "
            "assume t < every ciphertext prime and the decryption path "
            "centers 16-bit terms against t")
    if not _primes.is_prime(t):
        raise ValueError(f"plain_modulus {t} must be prime")
    if (t - 1) % (2 * n) != 0:
        raise ValueError(
            f"plain_modulus {t} does not support batching for n={n}: "
            "need t ≡ 1 (mod 2n)")
    k = max(2, math.ceil(security.log_q / PRIME_BITS))
    # Aux basis must give the tensor product headroom:
    #   prod(q ∪ B ∪ {m_sk}) > 4 * t * n * q^2, i.e. B*m_sk > 4*t*n*q.
    # The loop below sizes l exactly; for typical parameter sets it lands on
    # l = k + 1 (the conservative 2^29 lower bound per prime is within a bit
    # of the requirement at l = k — do NOT shortcut this to l = k).
    l = k
    while (1 << (29 * l + 29)) <= 4 * t * n * (1 << (PRIME_BITS * k)):
        l += 1
    pool = _primes.find_ntt_primes(n, k + l + 1, bits=PRIME_BITS, exclude=(t,))
    q_primes = tuple(pool[:k])
    aux_primes = tuple(pool[k : k + l])
    m_sk = pool[k + l]
    # gamma only needs to be coprime to q and t; reuse the NTT-prime generator
    # with the pool excluded so it is distinct.
    gamma = _primes.find_ntt_primes(n, 1, bits=PRIME_BITS, exclude=tuple(pool) + (t,))[0]
    return SchemeParams(
        security=security,
        n=n,
        t=t,
        q_primes=q_primes,
        aux_primes=aux_primes,
        m_sk=m_sk,
        gamma=gamma,
    )


def default_params(
    poly_degree: int = 4096, log_q: int = 120, **kw
) -> SchemeParams:
    return make_scheme_params(
        SecurityParams(poly_degree=poly_degree, log_q=log_q, **kw)
    )
