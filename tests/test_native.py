"""Native C++ host runtime vs pure-Python equivalence.

The C++ library (native/fhecore.cpp) must be bit-identical with
fhe_jax.primes / the table builder in fhe_jax.ops.ntt.  Skipped when the
shared library is not built AND cannot be auto-built (no compiler)."""

import numpy as np
import pytest

from fhe_jax.utils import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built")


def _python_only(monkeypatch):
    """Force the pure-Python fallback paths."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


def test_is_prime_agrees(monkeypatch):
    from fhe_jax import primes
    cases = [0, 1, 2, 3, 4, 65536, 65537, 12289, 40961,
             (1 << 30) - 35, (1 << 30) - 41, 999999937, 2**61 - 1]
    got_native = [primes.is_prime(x) for x in cases]
    _python_only(monkeypatch)
    got_python = [primes.is_prime(x) for x in cases]
    assert got_native == got_python


def test_find_ntt_primes_agrees(monkeypatch):
    from fhe_jax import primes
    a = primes.find_ntt_primes(2048, 5, bits=30, exclude=(65537,))
    _python_only(monkeypatch)
    b = primes.find_ntt_primes(2048, 5, bits=30, exclude=(65537,))
    assert a == b
    for p in a:
        assert p % 4096 == 1 and (1 << 29) < p < (1 << 30)


def test_find_ntt_primes_exhaustion():
    with pytest.raises(ValueError):
        native.find_ntt_primes(1 << 20, 10_000, 30, ())


def test_negacyclic_psi_agrees(monkeypatch):
    from fhe_jax import primes
    p = primes.find_ntt_primes(512, 1, bits=30)[0]
    a = primes.negacyclic_psi(512, p)
    _python_only(monkeypatch)
    b = primes.negacyclic_psi(512, p)
    assert a == b and pow(a, 512, p) == p - 1


def test_ntt_tables_bit_identical(monkeypatch):
    import fhe_jax.ops.ntt as nttmod
    from fhe_jax import primes
    n = 512
    ps = tuple(primes.find_ntt_primes(n, 3, bits=30))
    nttmod._build_tables_np.cache_clear()
    host_native = nttmod._build_tables_np(n, ps)
    _python_only(monkeypatch)
    nttmod._build_tables_np.cache_clear()
    host_python = nttmod._build_tables_np(n, ps)
    nttmod._build_tables_np.cache_clear()
    for key in host_native:
        assert np.array_equal(host_native[key], host_python[key]), key


def test_tables_for_fermat_prime_t():
    """The BatchEncoder's mod-t tables (t = 65537) must build natively too."""
    out = native.build_ntt_tables(256, 65537)
    assert out is not None
    psi_br = out[0]
    assert psi_br[0] == 1
