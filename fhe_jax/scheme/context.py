"""SchemeContext: the precomputed-constants pytree.

Counterpart of ``FHEContext::FHEContext`` (reference ``src/fhe.cu:7-40``, call
stack SURVEY.md §3.1): instead of a host object owning device pointers and
CUDA streams, all constant tables (NTT twiddles + Shoup companions, BEHZ base
conversion factors, decryption/modswitch constants, Galois permutations) are
built once on the host with exact integer arithmetic and live in a single
pytree that jitted scheme functions take as an argument.  ``params`` is a
static (hashable) field so shapes/levels trace correctly.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..params import SchemeParams, SecurityParams, make_scheme_params
from ..ops import ntt as _ntt
from ..ops import ntt_mxu as _ntt_mxu
from ..ops import rns as _rns
from ..utils import struct

_U = np.uint32


@struct.dataclass
class SchemeContext:
    params: SchemeParams = struct.field(pytree_node=False)

    # NTT engines (reference NTTEngine/RNS_NTTEngine, include/ntt.cuh:72-137)
    ntt_q: _ntt.NTTTables          # q basis
    ntt_bsk: _ntt.NTTTables        # Bsk basis (BEHZ multiply)
    # Four-step matmul engine tables (ops/ntt_mxu.py): used for the closed
    # fwd->pointwise->inv loops of the multiply tensor product, where the
    # engine's different evaluation order never meets stored NTT-form data
    # (reference "Tensor Core Acceleration" future-work item)
    ntt_q_mxu: "object | None"
    ntt_bsk_mxu: "object | None"
    use_mxu: bool = struct.field(pytree_node=False)

    # BEHZ multiply constants
    smq: _rns.SmMRqConsts          # q -> Bsk centered lift
    floor_c: _rns.FastFloorConsts  # q -> Bsk floor(t*x/q)
    sk_c: _rns.SKConsts            # Bsk -> q exact back-conversion

    # encrypt/decrypt constants
    dec_c: _rns.DecryptConsts      # gamma-trick decryption scaling
    delta_mod_q: jax.Array         # [k]  floor(q/t) mod q_i
    delta_shoup: jax.Array         # [k]

    # relinearization digit constants: D_j = [c2_j * (q/q_j)^-1]_{q_j}
    inv_qhat: jax.Array            # [k]
    inv_qhat_shoup: jax.Array

    # per-level variants of the above (index = level; [0] covers full q).
    # Leveled BFV multiply uses smq/floor/sk at the ciphertext's level;
    # leveled plain ops use delta_L = floor(q_L/t); leveled key switching
    # uses the level's digit constants.
    smq_levels: tuple[_rns.SmMRqConsts, ...]
    floor_levels: tuple[_rns.FastFloorConsts, ...]
    sk_levels: tuple[_rns.SKConsts, ...]
    # Bsk prime count per level.  The BEHZ exactness bound only needs
    # prod(B_L)*m_sk > 4*t*n*q_L, so as q shrinks the auxiliary base does
    # too (suffix of bsk_primes — m_sk, the SK anchor, is always last).
    # The bsk NTT tables above are sized for level 0; leveled transforms
    # take slice_tables_last(ntt_bsk*, bsk_counts[level]) zero-copy views.
    bsk_counts: tuple[int, ...] = struct.field(pytree_node=False)
    delta_levels: tuple[tuple[jax.Array, jax.Array], ...]     # (delta, shoup)
    inv_qhat_levels: tuple[tuple[jax.Array, jax.Array], ...]  # (inv, shoup)

    # modulus switching chain (level L -> L+1 drops prime k-1-L)
    mod_switch: tuple[_rns.ModSwitchConsts, ...]

    # per-level decryption constants (q shrinks with level)
    dec_levels: tuple[_rns.DecryptConsts, ...]

    # BGV companions (scheme/bgv.py): exact centered reduction q_level -> {t}
    # for decryption, and the t-corrected modulus switch
    bgv_dec_levels: tuple[_rns.SmMRqConsts, ...]
    bgv_mod_switch: tuple[_rns.BGVModSwitchConsts, ...]

    # Galois automorphism gather tables: g -> (src index [n], negate flag [n])
    galois_src: dict[int, jax.Array]
    galois_neg: dict[int, jax.Array]

    @property
    def k(self) -> int:
        return self.params.k

    @property
    def n(self) -> int:
        return self.params.n


def galois_permutation(n: int, g: int) -> tuple[np.ndarray, np.ndarray]:
    """Gather form of the automorphism a(x) -> a(x^g) on Z[x]/(x^n+1).

    Maps source coeff i to position g*i mod 2n (negated if >= n); returns the
    inverse map: out[j] = +-a[src[j]] (reference rotate_rows spec,
    ``include/fhe.cuh:113-116``)."""
    assert g % 2 == 1, "galois element must be odd"
    src = np.zeros(n, dtype=np.int32)
    neg = np.zeros(n, dtype=bool)
    for i in range(n):
        e = (g * i) % (2 * n)
        pos, flip = (e, False) if e < n else (e - n, True)
        src[pos] = i
        neg[pos] = flip
    return src, neg


@functools.lru_cache(maxsize=None)
def galois_perm_tables(n: int, g: int) -> tuple[jax.Array, jax.Array]:
    """Device (src, neg) gather tables for ANY odd Galois element — the
    cached fallback for elements outside the precomputed default set (e.g.
    non-power-of-two hoisted rotations, custom galoiskey_gen elements)."""
    src, neg = galois_permutation(n, g)
    return jnp.asarray(src), jnp.asarray(neg)


_GALOIS_FOLD_ROWS = 8


@functools.lru_cache(maxsize=None)
def galois_fold_tables(n: int, g: int):
    """Folded-affine factorization of the coefficient automorphism.

    src[j] = h*j mod n (h = g^-1 mod 2n) is AFFINE, so on a row-major
    [R, L] fold (j = a*L + b, R = 8, L = n/8):

        src_row(a, b) = (h*a + t_a(b)) mod R,   src_col(b) = t_b(b)

    with h*b mod n = t_a(b)*L + t_b(b).  The permutation factors into
      1. one lane gather with an L-length shared index (t_b),
      2. a per-column row rotation by t_a (R rolls + selects),
      3. a static row shuffle rho(a) = h*a mod R,
    shrinking the gather index 8x and moving the rest onto full-width ops.

    The gather-shrinking step RECURSES: t_b(l) = h*l mod L is itself
    affine (n = R*L kills the n-wraps mod L), so when L >= 1024 the L-length
    gather folds again onto [R2, L2] — one L2-length gather + R2 more row
    rolls.  Whether this beats the plain n-length gather
    (bfv._apply_galois_coeff's fallback) depends on the device's gather.

    Returns, as device arrays:
      * two-level (L >= 1024):  (t_b2 [L2], t_a2 [L2], t_a [R2, L2],
        rho [R], rho2 [R2], neg [R, R2, L2] bool)    — len 6
      * single-level:  (t_b [L], t_a [L], rho [R], neg [R, L] bool) — len 4
      * None when n < 1024 (L must stay >= 128) — bfv._apply_galois_coeff
        falls back to the plain gather then."""
    R = _GALOIS_FOLD_ROWS
    if n < R * 128:
        return None
    L = n // R
    h = pow(g, -1, 2 * n)
    b = np.arange(L, dtype=np.int64)
    hb = (h * b) % n
    t_a = (hb // L).astype(np.int32)
    t_b = (hb % L).astype(np.int32)
    rho = np.array([(h * a) % R for a in range(R)], dtype=np.int32)
    # verify the factorization against the reference table, row by row
    src_ref, neg_ref = galois_permutation(n, g)
    a_grid = np.arange(R)[:, None]
    rec = (((rho[a_grid] + t_a[None, :]) % R) * L + t_b[None, :])
    assert np.array_equal(rec.reshape(-1), src_ref), (n, g)
    R2 = _GALOIS_FOLD_ROWS
    if L < R2 * 128:
        return (jnp.asarray(t_b), jnp.asarray(t_a), jnp.asarray(rho),
                jnp.asarray(neg_ref.reshape(R, L)))
    L2 = L // R2
    b2 = np.arange(L2, dtype=np.int64)
    hb2 = (h * b2) % L
    t_a2 = (hb2 // L2).astype(np.int32)
    t_b2 = (hb2 % L2).astype(np.int32)
    rho2 = np.array([(h * a) % R2 for a in range(R2)], dtype=np.int32)
    # verify level 2: t_b's gather == the [R2, L2]-folded factorization
    a2_grid = np.arange(R2)[:, None]
    rec2 = (((rho2[a2_grid] + t_a2[None, :]) % R2) * L2 + t_b2[None, :])
    assert np.array_equal(rec2.reshape(-1), t_b), (n, g)
    return (jnp.asarray(t_b2), jnp.asarray(t_a2),
            jnp.asarray(t_a.reshape(R2, L2)), jnp.asarray(rho),
            jnp.asarray(rho2), jnp.asarray(neg_ref.reshape(R, R2, L2)))


@functools.lru_cache(maxsize=None)
def ks_group_conv_tables(primes: tuple[int, ...], omega: int):
    """Grouped-gadget base-extension weights (SEAL-style decomposition
    groups on the RNS basis; params.SecurityParams.ks_omega).

    Digit group g covers primes J_g = primes[g*omega : (g+1)*omega] with
    modulus q_Jg = prod(J_g).  The grouped digit D_g = [c * (q/q_Jg)^-1]_{q_Jg}
    is recovered from the STANDARD per-prime digits y_j = [c * (q/q_j)^-1]_{q_j}
    via CRT interpolation:

        sum_{j in J_g} y_j * (q_Jg / q_j)  =  D_g + alpha * q_Jg,  alpha < omega

    (identity: y_j = [D_g * (q_Jg/q_j)^-1]_{q_j} because
    (q/q_Jg)*(q_Jg/q_j) = q/q_j).  The alpha overflow is absorbed exactly by
    the gadget — q_Jg * (q/q_Jg) = q = 0 mod q — and only scales the key
    error by < omega * q_Jg (scheme/noise.keyswitch_add).

    Returns cw: [k, kd, omega] uint32 with cw[i, g, j] = (q_Jg / q_{J_g[j]})
    mod primes[i], zero-padded where the last group is short; D_g mod p_i =
    sum_j y[g*omega + j] * cw[i, g, j] mod p_i (zero pads contribute 0)."""
    import math as _math

    k = len(primes)
    kd = -(-k // omega)
    cw = np.zeros((k, kd, omega), dtype=_U)
    for g in range(kd):
        J = primes[g * omega: min((g + 1) * omega, k)]
        qJ = _math.prod(J)
        for jl, pj in enumerate(J):
            w = qJ // pj
            for i, pi in enumerate(primes):
                cw[i, g, jl] = w % pi
    return cw


def default_galois_elements(n: int) -> tuple[int, ...]:
    """Galois elements for power-of-two row rotations (both directions) plus
    the column swap g = 2n-1, mirroring SEAL-style key generation."""
    m = 2 * n
    elems = []
    step = 1
    while step < n // 2:
        elems.append(pow(3, step, m))
        elems.append(pow(3, -step, m))
        step *= 2
    elems.append(m - 1)
    return tuple(dict.fromkeys(elems))


@functools.lru_cache(maxsize=None)
def _level_host(primes: tuple[int, ...], t: int):
    """(delta_L, delta_shoup, inv_qhat_L, inv_qhat_shoup) for one level."""
    import math as _math

    q = _math.prod(primes)
    delta = q // t
    delta_mod = [delta % p for p in primes]
    inv_qhat = [pow(q // p, -1, p) for p in primes]
    return (
        np.array(delta_mod, dtype=_U), _rns._shoup_arr(delta_mod, primes),
        np.array(inv_qhat, dtype=_U), _rns._shoup_arr(inv_qhat, primes),
    )


def make_context(params: SchemeParams | None = None, use_mxu: bool = False,
                 **security_kw) -> SchemeContext:
    """Build the full constants pytree (reference FHEContext ctor analog).

    use_mxu: route the multiply tensor-product transforms through the
    four-step int8-matmul engine (ops/ntt_mxu.py) instead of the
    stage-sweep engine (ops/ntt.py).  Off by default; both are bit-exact
    in the tensor product."""
    if params is None:
        params = make_scheme_params(SecurityParams(**security_kw))
    n = params.n
    mod_switch = []
    dec_levels = []
    bgv_dec_levels = []
    bgv_mod_switch = []
    smq_levels = []
    floor_levels = []
    sk_levels = []
    bsk_counts = []
    delta_levels = []
    inv_qhat_levels = []
    chain = params.q_primes
    while len(chain) >= 1:
        dec_levels.append(_rns.make_decrypt(chain, params.t, params.gamma))
        bgv_dec_levels.append(
            _rns.make_sm_mrq(chain, (params.t,), params.m_tilde))
        # BEHZ aux base for this level: smallest SUFFIX of aux_primes with
        # prod(B_L) * m_sk > 4*t*n*q_L (the exactness bound params.py sizes
        # the level-0 base by).  Suffix so m_sk stays the last Bsk prime.
        if len(chain) == len(params.q_primes):
            # level 0 always uses the FULL base: bit-exactness with the
            # oracle's behz_multiply_no_relin is part of the test contract.
            aux_l = params.aux_primes
        else:
            q_l = 1
            for p_i in chain:
                q_l *= int(p_i)
            need = 4 * params.t * n * q_l
            l_lvl, prod_b = 0, params.m_sk
            while prod_b <= need:
                l_lvl += 1
                prod_b *= int(params.aux_primes[-l_lvl])
            aux_l = params.aux_primes[-l_lvl:] if l_lvl else ()
        bsk_l = aux_l + (params.m_sk,)
        bsk_counts.append(len(bsk_l))
        smq_levels.append(_rns.make_sm_mrq(chain, bsk_l, params.m_tilde))
        floor_levels.append(_rns.make_fast_floor(chain, bsk_l))
        sk_levels.append(_rns.make_sk(aux_l, params.m_sk, chain))
        d, ds, iq, iqs = _level_host(chain, params.t)
        delta_levels.append((jnp.asarray(d), jnp.asarray(ds)))
        inv_qhat_levels.append((jnp.asarray(iq), jnp.asarray(iqs)))
        if len(chain) >= 2:
            mod_switch.append(_rns.make_mod_switch(chain))
            bgv_mod_switch.append(_rns.make_bgv_mod_switch(chain, params.t))
        chain = chain[:-1]
    galois_src = {}
    galois_neg = {}
    for g in default_galois_elements(n):
        src, neg = galois_permutation(n, g)
        galois_src[g] = jnp.asarray(src)
        galois_neg[g] = jnp.asarray(neg)
    return SchemeContext(
        params=params,
        ntt_q=_ntt.build_tables(n, params.q_primes),
        ntt_bsk=_ntt.build_tables(n, params.bsk_primes),
        ntt_q_mxu=_ntt_mxu.build_mxu_tables(n, params.q_primes) if use_mxu else None,
        ntt_bsk_mxu=_ntt_mxu.build_mxu_tables(n, params.bsk_primes) if use_mxu else None,
        use_mxu=use_mxu,
        smq=smq_levels[0],
        floor_c=floor_levels[0],
        sk_c=sk_levels[0],
        dec_c=dec_levels[0],
        delta_mod_q=delta_levels[0][0],
        delta_shoup=delta_levels[0][1],
        inv_qhat=inv_qhat_levels[0][0],
        inv_qhat_shoup=inv_qhat_levels[0][1],
        mod_switch=tuple(mod_switch),
        dec_levels=tuple(dec_levels),
        bgv_dec_levels=tuple(bgv_dec_levels),
        bgv_mod_switch=tuple(bgv_mod_switch),
        smq_levels=tuple(smq_levels),
        floor_levels=tuple(floor_levels),
        sk_levels=tuple(sk_levels),
        bsk_counts=tuple(bsk_counts),
        delta_levels=tuple(delta_levels),
        inv_qhat_levels=tuple(inv_qhat_levels),
        galois_src=galois_src,
        galois_neg=galois_neg,
    )
