"""NTT-friendly prime generation and number-theory host utilities.

Counterpart of the reference's (stubbed) prime/root machinery:
  * ``generate_rns_primes`` / ``find_ntt_prime``  — reference ``src/rns.cu:183-209``
  * ``find_primitive_root`` / ``mod_inverse``     — reference ``src/ntt.cu:110-119``
  * Miller-Rabin ``is_prime``                     — declared ``include/rns.cuh:146``

All functions here are exact, host-side, pure Python.  They run once at
context-construction time (the analog of ``FHEContext::FHEContext``,
reference ``src/fhe.cu:7-40``) to build the constant tables that are then
``device_put`` onto the device.  A native C++ fast path lives in
``native/fhecore.cpp`` and is used transparently when built (see
``fhe_jax.utils.native``); every wrapper falls back to the Python body when
the shared library is absent, with bit-identical results.
"""

from __future__ import annotations

import functools

from .utils import native as _native

# Deterministic Miller-Rabin witness set: correct for all n < 3.3 * 10^24.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin primality test for 64-bit-ish integers.

    Replaces the reference's declared-but-stubbed ``is_prime``
    (``include/rns.cuh:146``).
    """
    fast = _native.is_prime(n) if n >= 0 else None
    if fast is not None:
        return fast
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_primes(
    n: int,
    count: int,
    bits: int = 30,
    exclude: tuple[int, ...] = (),
) -> list[int]:
    """Return ``count`` primes p with p ≡ 1 (mod 2n), descending from 2**bits.

    Mirrors ``generate_rns_primes`` (reference ``src/rns.cu:183-197``) but is
    actually correct.  All primes are kept strictly inside (2**(bits-1),
    2**bits) so that downstream Barrett constants fit in uint32 (we rely on
    2**(bits-1) < p < 2**bits with bits == 30 for the hot kernels).
    """
    fast = _native.find_ntt_primes(n, count, bits, tuple(exclude))
    if fast is not None:
        return fast
    two_n = 2 * n
    # Largest candidate ≡ 1 (mod 2n) below 2**bits.
    p = (1 << bits) - 1
    p -= (p - 1) % two_n
    out: list[int] = []
    lo = 1 << (bits - 1)
    while len(out) < count:
        if p <= lo:
            raise ValueError(
                f"not enough {bits}-bit NTT primes for n={n}, count={count}"
            )
        if p not in exclude and is_prime(p):
            out.append(p)
        p -= two_n
    return out


@functools.lru_cache(maxsize=None)
def _factorize(n: int) -> tuple[int, ...]:
    """Prime factors (unique) of n via trial division; n fits in ~64 bits."""
    fs = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        fs.append(n)
    return tuple(fs)


def primitive_root(p: int) -> int:
    """Smallest generator of (Z/p)^*.

    Replaces the reference's stub ``find_primitive_root`` which returned a
    constant 3 (``src/ntt.cu:110-114``).
    """
    if p == 2:
        return 1
    phi = p - 1
    factors = _factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // f, p) != 1 for f in factors):
            return g
        g += 1


def root_of_unity(order: int, p: int) -> int:
    """A primitive ``order``-th root of unity mod p (requires order | p-1).

    Replaces the reference's twiddle-base computation (``src/ntt.cu:87-97``,
    which filled ω^i with the placeholder ``i``).
    """
    if (p - 1) % order != 0:
        raise ValueError(f"{order} does not divide p-1 for p={p}")
    g = primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    # w has order dividing `order`; since g is a generator it is exactly order.
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) != 1
    return w


def negacyclic_psi(n: int, p: int) -> int:
    """Primitive 2n-th root of unity ψ mod p (ψ^n ≡ -1), for X^n + 1."""
    fast = _native.negacyclic_psi(n, p)
    if fast is not None:
        return fast
    psi = root_of_unity(2 * n, p)
    assert pow(psi, n, p) == p - 1
    return psi


def mod_inverse(a: int, p: int) -> int:
    """Modular inverse; replaces the reference stub ``src/ntt.cu:116-119``."""
    return pow(a, -1, p)


def bit_reverse(x: int, bits: int) -> int:
    """Reverse the low ``bits`` bits of x (reference ``ntt_kernels.cu:140-161``)."""
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r
