// fhecore — native host runtime for fhe_jax.
//
// C++ implementation of the host-side number theory the reference keeps in
// its CUDA host code (prime generation `src/rns.cu:183-209`, primitive roots
// and twiddle precompute `src/ntt.cu:77-119`, Montgomery parameter setup
// `src/bigint.cu:23-55` — all stubbed there, correct here).  The Python layer
// (`fhe_jax/utils/native.py`) loads this via ctypes and falls back to the
// pure-Python implementations in `fhe_jax/primes.py` when absent; results are
// bit-identical by construction (tests/test_native.py asserts it).
//
// Everything is exact 64/128-bit integer arithmetic; no floating point.

#include <cstdint>
#include <cstring>

using u32 = uint32_t;
using u64 = uint64_t;
using u128 = unsigned __int128;

extern "C" {

// ---------------------------------------------------------------------------
// modular primitives
// ---------------------------------------------------------------------------

u64 fhe_mul_mod(u64 a, u64 b, u64 m) {
    return (u64)((u128)a * b % m);
}

u64 fhe_pow_mod(u64 base, u64 exp, u64 m) {
    u64 r = 1 % m;
    base %= m;
    while (exp) {
        if (exp & 1) r = fhe_mul_mod(r, base, m);
        base = fhe_mul_mod(base, base, m);
        exp >>= 1;
    }
    return r;
}

// Modular inverse via extended Euclid; returns 0 if not invertible.
// Restricted to m < 2^63: the signed-arithmetic Euclid below would compute
// garbage on larger moduli (the library only ever uses word-size moduli).
u64 fhe_mod_inverse(u64 a, u64 m) {
    if (m >= (1ull << 63)) return 0;
    int64_t t = 0, newt = 1;
    int64_t r = (int64_t)m, newr = (int64_t)(a % m);
    while (newr != 0) {
        int64_t q = r / newr;
        int64_t tmp = t - q * newt; t = newt; newt = tmp;
        tmp = r - q * newr; r = newr; newr = tmp;
    }
    if (r > 1) return 0;
    if (t < 0) t += (int64_t)m;
    return (u64)t;
}

// ---------------------------------------------------------------------------
// primality (deterministic Miller-Rabin, same witness set as primes.py:
// correct for all n < 3.3e24)
// ---------------------------------------------------------------------------

static const u64 kWitnesses[] = {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37};

int fhe_is_prime(u64 n) {
    if (n < 2) return 0;
    for (u64 p : kWitnesses) {
        if (n % p == 0) return n == p;
    }
    u64 d = n - 1;
    int r = 0;
    while ((d & 1) == 0) { d >>= 1; ++r; }
    for (u64 a : kWitnesses) {
        u64 x = fhe_pow_mod(a, d, n);
        if (x == 1 || x == n - 1) continue;
        bool composite = true;
        for (int i = 0; i < r - 1; ++i) {
            x = fhe_mul_mod(x, x, n);
            if (x == n - 1) { composite = false; break; }
        }
        if (composite) return 0;
    }
    return 1;
}

// ---------------------------------------------------------------------------
// NTT prime generation: `count` primes p ≡ 1 (mod 2n), descending from
// 2^bits, all > 2^(bits-1).  Mirrors primes.find_ntt_primes exactly.
// Returns 0 on success, -1 if the range is exhausted.
// ---------------------------------------------------------------------------

int fhe_find_ntt_primes(u64 n, int count, int bits,
                        const u64* exclude, int n_exclude, u64* out) {
    const u64 two_n = 2 * n;
    u64 p = (1ull << bits) - 1;
    p -= (p - 1) % two_n;
    const u64 lo = 1ull << (bits - 1);
    int found = 0;
    while (found < count) {
        if (p <= lo) return -1;
        bool excluded = false;
        for (int i = 0; i < n_exclude; ++i) {
            if (exclude[i] == p) { excluded = true; break; }
        }
        if (!excluded && fhe_is_prime(p)) out[found++] = p;
        p -= two_n;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// primitive roots / roots of unity (mirror primes.primitive_root et al.)
// ---------------------------------------------------------------------------

// Unique prime factors of n by trial division (n ~ 2^30 here, so trivial).
static int factorize(u64 n, u64* factors) {
    int cnt = 0;
    for (u64 d = 2; d * d <= n; d += (d == 2 ? 1 : 2)) {
        if (n % d == 0) {
            factors[cnt++] = d;
            while (n % d == 0) n /= d;
        }
    }
    if (n > 1) factors[cnt++] = n;
    return cnt;
}

u64 fhe_primitive_root(u64 p) {
    if (p == 2) return 1;
    u64 phi = p - 1;
    u64 factors[64];
    int nf = factorize(phi, factors);
    for (u64 g = 2;; ++g) {
        bool ok = true;
        for (int i = 0; i < nf; ++i) {
            if (fhe_pow_mod(g, phi / factors[i], p) == 1) { ok = false; break; }
        }
        if (ok) return g;
    }
}

// Primitive order-th root of unity mod p; 0 if order does not divide p-1.
u64 fhe_root_of_unity(u64 order, u64 p) {
    if ((p - 1) % order != 0) return 0;
    u64 g = fhe_primitive_root(p);
    u64 w = fhe_pow_mod(g, (p - 1) / order, p);
    if (fhe_pow_mod(w, order / 2, p) == 1) return 0;  // not primitive
    return w;
}

// psi with psi^n = -1 (mod p); 0 on failure.
u64 fhe_negacyclic_psi(u64 n, u64 p) {
    u64 psi = fhe_root_of_unity(2 * n, p);
    if (psi == 0 || fhe_pow_mod(psi, n, p) != p - 1) return 0;
    return psi;
}

// ---------------------------------------------------------------------------
// NTT table builder — the hot host path (ops/ntt.py `_build_tables_np` inner
// loop; the reference's `precompute_twiddle_factors`, src/ntt.cu:77-107).
// Emits psi^brv(i) / psi^-brv(i) power tables with Shoup companions and the
// n^-1 constants, all for one prime.  Returns 0 on success.
// ---------------------------------------------------------------------------

static inline u32 bit_reverse(u32 x, int bits) {
    u32 r = 0;
    for (int i = 0; i < bits; ++i) { r = (r << 1) | (x & 1); x >>= 1; }
    return r;
}

static inline u32 shoup(u64 w, u64 p) {
    return (u32)(((u128)w << 32) / p);
}

int fhe_build_ntt_tables(u64 n, u64 p,
                         u32* psi_br, u32* psi_br_shoup,
                         u32* ipsi_br, u32* ipsi_br_shoup,
                         u32* n_inv_out, u32* n_inv_shoup_out) {
    const u64 psi = fhe_negacyclic_psi(n, p);
    if (psi == 0) return -1;
    const u64 ipsi = fhe_mod_inverse(psi, p);
    if (ipsi == 0) return -1;
    int bits = 0;
    while ((1ull << bits) < n) ++bits;
    if ((1ull << bits) != n) return -1;

    // pows[i] = psi^i; write both tables at the bit-reversed position.
    u64 x = 1, y = 1;
    for (u64 i = 0; i < n; ++i) {
        u32 j = bit_reverse((u32)i, bits);
        // invariant brv is an involution: position j holds psi^brv(j).
        psi_br[j] = (u32)x;
        psi_br_shoup[j] = shoup(x, p);
        ipsi_br[j] = (u32)y;
        ipsi_br_shoup[j] = shoup(y, p);
        x = fhe_mul_mod(x, psi, p);
        y = fhe_mul_mod(y, ipsi, p);
    }
    const u64 n_inv = fhe_mod_inverse(n % p, p);
    *n_inv_out = (u32)n_inv;
    *n_inv_shoup_out = shoup(n_inv, p);
    return 0;
}

// ---------------------------------------------------------------------------
// Montgomery / Barrett host constants (reference src/bigint.cu:23-55, whose
// r_squared was a placeholder; correct here for word-size primes).
// ---------------------------------------------------------------------------

// returns p_neg_inv = -p^-1 mod 2^32; writes r2 = 2^64 mod p, r1 = 2^32 mod p.
u64 fhe_montgomery_params(u64 p, u64* r2, u64* r1) {
    // Newton iteration for p^-1 mod 2^64, then truncate to 2^32.
    u64 inv = p;  // p odd: p*p ≡ 1 mod 8 start
    for (int i = 0; i < 6; ++i) inv *= 2 - p * inv;  // mod 2^64 Newton
    u64 inv32 = inv & 0xFFFFFFFFull;
    *r1 = ((u128)1 << 32) % p;
    *r2 = (u64)(((u128)1 << 64) % p);
    return (0x100000000ull - inv32) & 0xFFFFFFFFull;
}

u64 fhe_barrett_mu(u64 p) {
    // mu = floor(2^61 / p); caller guarantees 2^29 < p < 2^30.
    return (u64)(((u128)1 << 61) / p);
}

int fhe_version() { return 1; }

}  // extern "C"
