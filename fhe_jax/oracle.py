"""Arbitrary-precision host oracle for the BFV pipeline.

The reference repo's arithmetic internals are stubs (SURVEY.md preamble): its
twiddles are filled with ``i`` (``src/ntt.cu:87-97``), CRT reconstruction is an
empty loop (``src/rns.cu:130-140``), and two kernels it calls are never defined.
The functional spec is therefore the API surface + docs + test expectations,
and *this module* is the mathematical ground truth: every device kernel in
``fhe_jax.ops`` / ``fhe_jax.scheme`` is tested bit-exactly against the
functions here (pure Python ints, no floating point, no JAX).

It mirrors, exactly, the algorithms the device code implements:
  * negacyclic NTT (merged-psi Cooley-Tukey / Gentleman-Sande, Harvey style)
  * RNS fast base conversion, SmMRq, FastFloor, FastBConvSK (BEHZ-style
    all-integer RNS-BFV; chosen over HPS so no float64 is needed)
  * gamma-correction exact RNS decryption
  * the full BFV scheme on big integers (keygen/encrypt/decrypt/add/mul).
"""

from __future__ import annotations

import dataclasses
import math
import random

from . import primes as _primes
from .params import SchemeParams

# ---------------------------------------------------------------------------
# Basic modular/poly helpers (exact)
# ---------------------------------------------------------------------------


def round_div(a: int, b: int) -> int:
    """round(a/b) for b > 0, half-up, exact for negative a too."""
    return (a + b // 2) // b if a >= 0 else -((-a + (b - 1) // 2) // b)


def center(x: int, m: int) -> int:
    """Map x mod m to the centered representative in (-m/2, m/2]."""
    x %= m
    return x - m if x > m // 2 else x


def kronecker_negacyclic_mul(a: list[int], b: list[int], coeff_bound: int) -> list[int]:
    """Exact negacyclic convolution of integer polys via Kronecker substitution.

    Independent of any NTT code (used to validate the NTTs themselves).
    ``coeff_bound`` must exceed every |coefficient| of the full 2n-1 product.
    """
    n = len(a)
    e = coeff_bound.bit_length() + 1
    mask = (1 << e) - 1
    ai = sum(x << (i * e) for i, x in enumerate(a))
    bi = sum(x << (i * e) for i, x in enumerate(b))
    prod = ai * bi
    full = [(prod >> (i * e)) & mask for i in range(2 * n)]
    return [full[i] - full[i + n] for i in range(n)]


def negacyclic_mul_mod(a: list[int], b: list[int], q: int) -> list[int]:
    n = len(a)
    bound = n * (q - 1) * (q - 1) + 1
    return [c % q for c in kronecker_negacyclic_mul([x % q for x in a], [x % q for x in b], bound)]


# ---------------------------------------------------------------------------
# Negacyclic NTT (merged psi powers, bit-reversed twiddle tables)
# ---------------------------------------------------------------------------
# Algorithm of record for the device engine (ops/ntt.py): Cooley-Tukey DIT
# forward (natural -> bit-reversed), Gentleman-Sande DIF inverse (bit-reversed
# -> natural), psi powers folded into the twiddles so no separate pre/post
# twist or bit-reverse pass is needed.  This replaces
# the reference's bit_reverse_kernel + shared-memory CT kernel
# (kernels/ntt_kernels.cu:7-62,140-161) and the Stockham variant its docs
# recommend (docs/NTT_OPTIMIZATION.md:41-49).


@dataclasses.dataclass(frozen=True)
class NTTTables:
    n: int
    p: int
    psi: int
    psi_br: tuple[int, ...]       # psi^brv(i), i in [0, n)
    ipsi_br: tuple[int, ...]      # psi^-brv(i)
    n_inv: int                    # n^-1 mod p


def build_ntt_tables(n: int, p: int) -> NTTTables:
    psi = _primes.negacyclic_psi(n, p)
    ipsi = pow(psi, -1, p)
    bits = n.bit_length() - 1
    psi_br = tuple(pow(psi, _primes.bit_reverse(i, bits), p) for i in range(n))
    ipsi_br = tuple(pow(ipsi, _primes.bit_reverse(i, bits), p) for i in range(n))
    return NTTTables(n=n, p=p, psi=psi, psi_br=psi_br, ipsi_br=ipsi_br,
                     n_inv=pow(n, -1, p))


def ntt_forward(a: list[int], tb: NTTTables) -> list[int]:
    """Forward negacyclic NTT, natural input -> bit-reversed output."""
    a = [x % tb.p for x in a]
    n, p = tb.n, tb.p
    t = n
    m = 1
    while m < n:
        t //= 2
        for i in range(m):
            w = tb.psi_br[m + i]
            j0 = 2 * i * t
            for j in range(j0, j0 + t):
                u = a[j]
                v = a[j + t] * w % p
                a[j] = (u + v) % p
                a[j + t] = (u - v) % p
        m *= 2
    return a


def ntt_inverse(a: list[int], tb: NTTTables) -> list[int]:
    """Inverse negacyclic NTT, bit-reversed input -> natural output."""
    a = [x % tb.p for x in a]
    n, p = tb.n, tb.p
    t = 1
    m = n // 2
    while m >= 1:
        for i in range(m):
            w = tb.ipsi_br[m + i]
            j0 = 2 * i * t
            for j in range(j0, j0 + t):
                u = a[j]
                v = a[j + t]
                a[j] = (u + v) % p
                a[j + t] = (u - v) * w % p
        t *= 2
        m //= 2
    return [x * tb.n_inv % p for x in a]


# ---------------------------------------------------------------------------
# RNS / CRT layer (reference include/rns.cuh, src/rns.cu — stubbed there)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RNSBasis:
    primes: tuple[int, ...]

    @property
    def Q(self) -> int:
        return math.prod(self.primes)

    def qhat(self, i: int) -> int:
        return self.Q // self.primes[i]

    def inv_qhat_mod_qi(self, i: int) -> int:
        return pow(self.qhat(i), -1, self.primes[i])


def to_rns(x: list[int], basis: RNSBasis) -> list[list[int]]:
    """[k][n] residues (reference RNS layout src/rns.cu:143-180 is
    value-major; ours is prime-major to shard the leading axis)."""
    return [[c % p for c in x] for p in basis.primes]


def from_rns(res: list[list[int]], basis: RNSBasis) -> list[int]:
    """Exact CRT reconstruction (reference from_rns_crt_kernel stub,
    src/rns.cu:117-141)."""
    Q = basis.Q
    out = [0] * len(res[0])
    for i, p in enumerate(basis.primes):
        mult = basis.qhat(i) * basis.inv_qhat_mod_qi(i) % Q
        for j, r in enumerate(res[i]):
            out[j] = (out[j] + r * mult) % Q
    return out


def fast_base_conv(res: list[list[int]], from_basis: RNSBasis,
                   to_primes: tuple[int, ...]) -> list[list[int]]:
    """Bajard fast base conversion: returns residues of (x + alpha*Q),
    0 <= alpha < k, in the target primes (reference declared-only
    fast_base_conversion_kernel, include/rns.cuh:116-125)."""
    n = len(res[0])
    k = len(from_basis.primes)
    y = [[res[i][j] * from_basis.inv_qhat_mod_qi(i) % from_basis.primes[i]
          for j in range(n)] for i in range(k)]
    out = []
    for c in to_primes:
        qhat_mod_c = [from_basis.qhat(i) % c for i in range(k)]
        out.append([sum(y[i][j] * qhat_mod_c[i] for i in range(k)) % c
                    for j in range(n)])
    return out


def sm_mrq(x_res: list[list[int]], q_basis: RNSBasis, m_tilde: int,
           to_primes: tuple[int, ...]) -> list[list[int]]:
    """Small Montgomery reduction mod m_tilde: exact conversion of x (in q)
    to the target base, removing the alpha*q overflow of fast_base_conv.
    BEHZ'16 step; input must satisfy x in [0, q)."""
    n = len(x_res[0])
    k = len(q_basis.primes)
    Q = q_basis.Q
    # x' = m_tilde * x in base q
    xp = [[x_res[i][j] * m_tilde % q_basis.primes[i] for j in range(n)]
          for i in range(k)]
    conv = fast_base_conv(xp, q_basis, tuple(to_primes) + (m_tilde,))
    conv_mt = conv[-1]
    # conv = m_tilde*x + delta*q as an integer, where delta = alpha - beta,
    # alpha in [0, k) from fast_base_conv and beta = floor(m_tilde*x/q) from
    # the mod-q reduction of x'.  delta is recovered centered mod m_tilde, so
    # the result is the *centered* lift: exactly x, or x - q (for x > ~q/2).
    inv_q = pow(Q, -1, m_tilde)
    out = []
    for ci, c in enumerate(to_primes):
        inv_mt_c = pow(m_tilde, -1, c)
        q_mod_c = Q % c
        row = []
        for j in range(n):
            delta = center(conv_mt[j] * inv_q % m_tilde, m_tilde)
            row.append((conv[ci][j] - delta * q_mod_c) * inv_mt_c % c)
        out.append(row)
    return out


def fast_floor(tx_q: list[list[int]], tx_bsk: list[list[int]],
               q_basis: RNSBasis, bsk_primes: tuple[int, ...]) -> list[list[int]]:
    """Approximate floor(tx/q) in the Bsk base: exact value is
    floor(tx/q) - alpha with 0 <= alpha < k (absorbed into scheme noise)."""
    n = len(tx_q[0])
    conv = fast_base_conv(tx_q, q_basis, bsk_primes)
    Q = q_basis.Q
    out = []
    for ci, c in enumerate(bsk_primes):
        inv_q_c = pow(Q, -1, c)
        out.append([(tx_bsk[ci][j] - conv[ci][j]) * inv_q_c % c
                    for j in range(n)])
    return out


def fast_bconv_sk(x_bsk: list[list[int]], aux_primes: tuple[int, ...],
                  m_sk: int, to_primes: tuple[int, ...]) -> list[list[int]]:
    """Shenoy-Kumaresan exact conversion Bsk -> q for |x| < B*m_sk/2-ish.

    x_bsk holds residues in B = aux_primes followed by m_sk (last row)."""
    n = len(x_bsk[0])
    b_basis = RNSBasis(tuple(aux_primes))
    B = b_basis.Q
    conv_q = fast_base_conv(x_bsk[:-1], b_basis, to_primes)
    conv_sk = fast_base_conv(x_bsk[:-1], b_basis, (m_sk,))[0]
    inv_B_sk = pow(B, -1, m_sk)
    out = []
    for ci, c in enumerate(to_primes):
        B_mod_c = B % c
        row = []
        for j in range(n):
            alpha = (conv_sk[j] - x_bsk[-1][j]) * inv_B_sk % m_sk
            alpha = center(alpha, m_sk)
            row.append((conv_q[ci][j] - alpha * B_mod_c) % c)
        out.append(row)
    return out


def decrypt_scale_gamma(x_res: list[list[int]], q_basis: RNSBasis,
                        t: int, gamma: int) -> list[int]:
    """Exact m = round(t*x/q) mod t from RNS residues, via the gamma trick
    (BEHZ exact RNS decryption) — all word-size integer ops.

    Replaces the reference's undefined poly_mod_switch_kernel decrypt scaling
    (called src/fhe.cu:181-184, spec docs/ARCHITECTURE.md:290-296)."""
    n = len(x_res[0])
    k = len(q_basis.primes)
    # z = [gamma*t*x]_q residues
    z = [[x_res[i][j] * (gamma * t % q_basis.primes[i]) % q_basis.primes[i]
          for j in range(n)] for i in range(k)]
    conv = fast_base_conv(z, q_basis, (t, gamma))
    Q = q_basis.Q
    s_t = [(-conv[0][j]) * pow(Q, -1, t) % t for j in range(n)]
    s_g = [(-conv[1][j]) * pow(Q, -1, gamma) % gamma for j in range(n)]
    inv_gamma_t = pow(gamma, -1, t)
    out = []
    for j in range(n):
        e_hat = center(s_g[j], gamma)
        out.append((s_t[j] - e_hat) * inv_gamma_t % t)
    return out


def mod_switch_drop_last(x_res: list[list[int]], primes: tuple[int, ...]) -> list[list[int]]:
    """round(x / q_last) into the basis without the last prime (RNS modulus
    switching; reference declared-only rns_mod_switch_kernel,
    include/rns.cuh:128-136)."""
    n = len(x_res[0])
    q_last = primes[-1]
    out = []
    for i, p in enumerate(primes[:-1]):
        inv_qlast = pow(q_last, -1, p)
        row = []
        for j in range(n):
            delta = center(x_res[-1][j], q_last)
            row.append((x_res[i][j] - delta) * inv_qlast % p)
        out.append(row)
    return out


def behz_multiply_no_relin(params: SchemeParams,
                           ct_a: list[list[int]],
                           ct_b: list[list[int]]) -> list[list[list[int]]]:
    """BEHZ-style RNS tensor product + t/q scaling, exact integer model.

    This function is the *bit-exact spec* for the device multiply
    (fhe_jax/scheme/bfv.py): same bases, same floors, same order of ops.
    Inputs/outputs are 2- resp. 3-component ciphertexts as [comp][n] big-int
    coefficient lists in [0, q).
    """
    q_basis = RNSBasis(params.q_primes)
    bsk = params.bsk_primes
    n = params.n
    t = params.t

    def to_q(poly):
        return [[c % p for c in poly] for p in params.q_primes]

    # Step 1: lift each component to Bsk (centered) via SmMRq.
    lifted_a = [sm_mrq(to_q(c), q_basis, params.m_tilde, bsk) for c in ct_a]
    lifted_b = [sm_mrq(to_q(c), q_basis, params.m_tilde, bsk) for c in ct_b]

    # Step 2: tensor products in base q and base Bsk (negacyclic convs).
    def conv_mod(res_a, res_b, prms):
        out = []
        for i, p in enumerate(prms):
            out.append(negacyclic_mul_mod(res_a[i], res_b[i], p))
        return out

    def add_res(x, y, prms):
        return [[(a + b) % p for a, b in zip(x[i], y[i])]
                for i, p in enumerate(prms)]

    a_q = [to_q(c) for c in ct_a]
    b_q = [to_q(c) for c in ct_b]
    tens_q = [
        conv_mod(a_q[0], b_q[0], params.q_primes),
        add_res(conv_mod(a_q[0], b_q[1], params.q_primes),
                conv_mod(a_q[1], b_q[0], params.q_primes), params.q_primes),
        conv_mod(a_q[1], b_q[1], params.q_primes),
    ]
    tens_bsk = [
        conv_mod(lifted_a[0], lifted_b[0], bsk),
        add_res(conv_mod(lifted_a[0], lifted_b[1], bsk),
                conv_mod(lifted_a[1], lifted_b[0], bsk), bsk),
        conv_mod(lifted_a[1], lifted_b[1], bsk),
    ]

    # Step 3+4: scale by t, FastFloor to Bsk, convert back to q via SK.
    out = []
    for comp in range(3):
        tx_q = [[v * t % p for v in tens_q[comp][i]]
                for i, p in enumerate(params.q_primes)]
        tx_bsk = [[v * t % p for v in tens_bsk[comp][i]]
                  for i, p in enumerate(bsk)]
        floored = fast_floor(tx_q, tx_bsk, q_basis, bsk)
        back = fast_bconv_sk(floored, params.aux_primes, params.m_sk,
                             params.q_primes)
        # Recover big-int coefficients in [0, q) for the caller.
        out.append(back)
    # Return as big-int coefficient lists via CRT.
    return [from_rns(res, q_basis) for res in out]


# ---------------------------------------------------------------------------
# Full BFV scheme on big integers
# ---------------------------------------------------------------------------


class BFVOracle:
    """Textbook BFV over Z_q[x]/(x^n + 1) with exact big-int arithmetic.

    Conventions (shared with the device implementation, fhe_jax/scheme/bfv.py):
      * coefficients kept in [0, q)
      * pk = (e - a*s, a)                      (reference src/fhe.cu:54-74)
      * enc(m) = (pk0*u + e1 + Delta*m, pk1*u + e2)   (src/fhe.cu:138-169)
      * dec(ct) = round(t*[ct(s)]_q / q) mod t        (src/fhe.cu:171-185)
      * mul: c_i = round(t * (a (x) b)_i / q) mod q over [0,q) reps
    """

    def __init__(self, params: SchemeParams, seed: int = 0):
        self.params = params
        self.rng = random.Random(seed)
        self.q = params.q
        self.t = params.t
        self.n = params.n
        self.delta = params.delta

    # -- sampling (oracle-local randomness; device uses jax.random) --
    def sample_uniform(self) -> list[int]:
        return [self.rng.randrange(self.q) for _ in range(self.n)]

    def sample_ternary(self) -> list[int]:
        h = self.params.security.hamming_weight
        coeffs = [0] * self.n
        idx = self.rng.sample(range(self.n), h)
        for i in idx:
            coeffs[i] = self.rng.choice((1, self.q - 1))
        return coeffs

    def sample_error(self) -> list[int]:
        sigma = self.params.security.sigma
        out = []
        for _ in range(self.n):
            e = round(self.rng.gauss(0.0, sigma))
            out.append(e % self.q)
        return out

    # -- poly ring helpers mod q --
    def _add(self, a, b):
        return [(x + y) % self.q for x, y in zip(a, b)]

    def _sub(self, a, b):
        return [(x - y) % self.q for x, y in zip(a, b)]

    def _mul(self, a, b):
        return negacyclic_mul_mod(a, b, self.q)

    # -- scheme ops --
    def keygen(self):
        s = self.sample_ternary()
        a = self.sample_uniform()
        e = self.sample_error()
        pk0 = self._sub(e, self._mul(a, s))
        return (pk0, a), s

    def encrypt(self, pk, m_poly: list[int]):
        """m_poly: coefficients mod t."""
        u = self.sample_ternary()
        e1 = self.sample_error()
        e2 = self.sample_error()
        scaled = [self.delta * (c % self.t) % self.q for c in m_poly]
        c0 = self._add(self._add(self._mul(pk[0], u), e1), scaled)
        c1 = self._add(self._mul(pk[1], u), e2)
        return [c0, c1]

    def ct_eval_at_s(self, ct, s) -> list[int]:
        """c0 + c1*s (+ c2*s^2 ...) mod q."""
        acc = list(ct[0])
        spow = s
        for comp in ct[1:]:
            acc = self._add(acc, self._mul(comp, spow))
            spow = self._mul(spow, s)
        return acc

    def decrypt(self, ct, s) -> list[int]:
        x = self.ct_eval_at_s(ct, s)
        return [round_div(self.t * c, self.q) % self.t for c in x]

    def noise_of(self, ct, s, m_poly) -> int:
        """Infinity norm of the noise v where ct(s) = Delta*m + v (mod q)."""
        x = self.ct_eval_at_s(ct, s)
        worst = 0
        for j, c in enumerate(x):
            v = center((c - self.delta * (m_poly[j] % self.t)) % self.q, self.q)
            worst = max(worst, abs(v))
        return worst

    def add(self, ca, cb):
        return [self._add(a, b) for a, b in zip(ca, cb)]

    def multiply_no_relin(self, ca, cb):
        """Tensor product + t/q scaling -> 3-component ct
        (reference src/fhe.cu:199-224)."""
        assert len(ca) == 2 and len(cb) == 2
        bound = self.n * (self.q - 1) ** 2 + 1
        prods = {}
        for i in range(2):
            for j in range(2):
                prods[(i, j)] = kronecker_negacyclic_mul(ca[i], cb[j], bound)
        c0 = prods[(0, 0)]
        c1 = [x + y for x, y in zip(prods[(0, 1)], prods[(1, 0)])]
        c2 = prods[(1, 1)]
        out = []
        for comp in (c0, c1, c2):
            out.append([round_div(self.t * c, self.q) % self.q for c in comp])
        return out

    def relin_keygen(self, s):
        """RNS-decomposition relinearization keys: one (b, a) pair per q-prime,
        key_j = (-a_j*s + e_j + qhat_j*s^2, a_j) mod q.
        RNS analog of the reference's base-2^w decomposition keys
        (src/fhe.cu:76-111): the decomposition digits are the CRT components."""
        basis = RNSBasis(self.params.q_primes)
        s2 = self._mul(s, s)
        keys = []
        for jidx in range(len(basis.primes)):
            w = basis.qhat(jidx) % self.q
            a = self.sample_uniform()
            e = self.sample_error()
            b = self._add(self._sub(e, self._mul(a, s)),
                          [w * c % self.q for c in s2])
            keys.append((b, a))
        return keys

    def relinearize(self, ct3, rlk):
        """3 -> 2 components via RNS-digit key switching."""
        assert len(ct3) == 3
        basis = RNSBasis(self.params.q_primes)
        c0, c1, c2 = ct3
        acc0 = list(c0)
        acc1 = list(c1)
        for jidx, (b, a) in enumerate(rlk):
            pj = basis.primes[jidx]
            dj = [(c % pj) * basis.inv_qhat_mod_qi(jidx) % pj for c in c2]
            acc0 = self._add(acc0, self._mul(dj, b))
            acc1 = self._add(acc1, self._mul(dj, a))
        return [acc0, acc1]

    def multiply(self, ca, cb, rlk):
        return self.relinearize(self.multiply_no_relin(ca, cb), rlk)


# ---------------------------------------------------------------------------
# BGV oracle (the second scheme of the reference's "BGV/BFV" declaration,
# include/fhe.cuh module doc / docs/ARCHITECTURE.md "Layer 5: FHE Scheme")
# ---------------------------------------------------------------------------


class BGVOracle(BFVOracle):
    """Textbook BGV: plaintext in the LSB (phase = m + t*e), multiplication
    without rescaling, modulus switching with a mod-t correction.

    Shares sampling and ring helpers with BFVOracle; conventions match the
    device implementation in fhe_jax/scheme/bgv.py.
    """

    def keygen(self):
        """pk = (t*e - a*s, a) so that pk0 + pk1*s = t*e."""
        s = self.sample_ternary()
        a = self.sample_uniform()
        e = self.sample_error_small()
        pk0 = self._sub([self.t * c % self.q for c in e], self._mul(a, s))
        return (pk0, a), s

    def sample_error_small(self) -> list[int]:
        """Signed error as centered ints (not yet reduced), for t*e scaling."""
        sigma = self.params.security.sigma
        return [round(self.rng.gauss(0.0, sigma)) for _ in range(self.n)]

    def encrypt(self, pk, m_poly: list[int]):
        u = self.sample_ternary()
        e1 = self.sample_error_small()
        e2 = self.sample_error_small()
        m = [c % self.t for c in m_poly]
        c0 = self._add(self._add(self._mul(pk[0], u),
                                 [self.t * c % self.q for c in e1]), m)
        c1 = self._add(self._mul(pk[1], u),
                       [self.t * c % self.q for c in e2])
        return [c0, c1]

    def decrypt(self, ct, s, scale_t: int = 1, q: int | None = None) -> list[int]:
        """scale_t: accumulated mod-switch correction factor (SEAL-style);
        each dropped prime q_last multiplies the underlying plaintext by
        q_last^-1 mod t, so decrypt multiplies back by scale_t = prod(dropped).

        q: the ciphertext modulus when it differs from self.q — REQUIRED for
        the output of mod_switch_drop_last (pass q = self.q // q_last and the
        secret reduced mod it); phase evaluation and centering then run mod
        the shrunk modulus, matching the device's per-level constants."""
        q_eff = self.q if q is None else q
        acc = [c % q_eff for c in ct[0]]
        spow = [c % q_eff for c in s]
        s_red = list(spow)
        for comp in ct[1:]:
            prod = negacyclic_mul_mod([c % q_eff for c in comp], spow, q_eff)
            acc = [(x + y) % q_eff for x, y in zip(acc, prod)]
            spow = negacyclic_mul_mod(spow, s_red, q_eff)
        return [center(c, q_eff) * scale_t % self.t for c in acc]

    def noise_of(self, ct, s, m_poly) -> int:
        """Infinity norm of t*e where ct(s) = m + t*e (mod q), centered."""
        x = self.ct_eval_at_s(ct, s)
        worst = 0
        for j, c in enumerate(x):
            v = center((c - (m_poly[j] % self.t)) % self.q, self.q)
            worst = max(worst, abs(v))
        return worst

    def multiply_no_relin(self, ca, cb):
        """Plain tensor product mod q — BGV never rescales in multiply."""
        assert len(ca) == 2 and len(cb) == 2
        prods = {}
        for i in range(2):
            for j in range(2):
                prods[(i, j)] = self._mul(ca[i], cb[j])
        c1 = self._add(prods[(0, 1)], prods[(1, 0)])
        return [prods[(0, 0)], c1, prods[(1, 1)]]

    def relin_keygen(self, s):
        """Same RNS-digit gadget as BFV but with t-scaled error."""
        basis = RNSBasis(self.params.q_primes)
        s2 = self._mul(s, s)
        keys = []
        for jidx in range(len(basis.primes)):
            w = basis.qhat(jidx) % self.q
            a = self.sample_uniform()
            e = self.sample_error_small()
            b = self._add(self._sub([self.t * c % self.q for c in e],
                                    self._mul(a, s)),
                          [w * c % self.q for c in s2])
            keys.append((b, a))
        return keys

    def mod_switch_drop_last(self, ct):
        """ct mod q -> ct' mod q/q_last with phase' = (phase - d)/q_last,
        d = t*[[c*t^-1]]_{q_last} (centered), so d = phase (mod q_last) and
        d = 0 (mod t).  The division multiplies the underlying plaintext by
        q_last^-1 mod t — the caller tracks scale_t *= q_last (see decrypt)."""
        q_last = self.params.q_primes[-1]
        q_new = self.q // q_last
        t_inv = pow(self.t, -1, q_last)
        out = []
        for comp in ct:
            new_comp = []
            for c in comp:
                d = self.t * center(c * t_inv % q_last, q_last)
                new_comp.append((c - d) // q_last % q_new)
            out.append(new_comp)
        return out


# ---------------------------------------------------------------------------
# Slot (SIMD) encoding oracle, mod t (BatchEncoder ground truth)
# ---------------------------------------------------------------------------


def slot_orbit_indices(n: int) -> tuple[list[int], list[int]]:
    """Standard BFV slot layout: slot j of row 0 evaluates at zeta^(3^j),
    row 1 at zeta^(-3^j) (2x(n/2) matrix; reference docs/ARCHITECTURE.md:514-521).

    Returns, for each slot, the NTT output position holding that evaluation,
    given our forward NTT's output ordering: output[i] = a(psi^(2*brv(i)+1)).
    """
    bits = n.bit_length() - 1
    half = n // 2
    row0, row1 = [], []
    g = 1
    m = 2 * n
    for _ in range(half):
        row0.append(_primes.bit_reverse((g - 1) // 2, bits))
        row1.append(_primes.bit_reverse((m - g - 1) // 2, bits))
        g = g * 3 % m
    return row0, row1


def slot_encode(values: list[int], n: int, t: int, tb: NTTTables) -> list[int]:
    """values (<= n entries, row-major over the 2x(n/2) matrix) -> pt coeffs mod t."""
    row0, row1 = slot_orbit_indices(n)
    evals = [0] * n
    half = n // 2
    for j, v in enumerate(values):
        pos = row0[j] if j < half else row1[j - half]
        evals[pos] = v % t
    return ntt_inverse(evals, tb)


def slot_decode(pt: list[int], n: int, t: int, tb: NTTTables) -> list[int]:
    evals = ntt_forward(pt, tb)
    row0, row1 = slot_orbit_indices(n)
    return [evals[i] for i in row0] + [evals[i] for i in row1]
