"""Device RNS layer vs oracle — bit-exact for every primitive.

Covers the reference's RNS component (SURVEY.md §2.6) with real assertions:
fast base conversion, SmMRq centered lift, FastFloor, Shenoy-Kumaresan
conversion, gamma decryption scaling, and RNS modulus switching."""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_jax import oracle, primes
from fhe_jax.params import SecurityParams, make_scheme_params
from fhe_jax.ops import rns

RNG = np.random.default_rng(21)
N, B = 32, 2

PARAMS = make_scheme_params(
    SecurityParams(poly_degree=N, log_q=90, hamming_weight=8)
)
QB = oracle.RNSBasis(PARAMS.q_primes)


def rand_res(prime_list, bound=None):
    """Random big-int coefficients < prod(primes), returned as ints + residues."""
    Q = math.prod(int(p) for p in prime_list)
    bound = bound or Q
    xs = [[int(RNG.integers(0, min(bound, 2**63))) * int(RNG.integers(0, 2**30)) % bound
           for _ in range(N)] for _ in range(B)]
    res = np.stack([
        np.array([[x % int(p) for x in row] for row in xs], dtype=np.uint32)
        for p in prime_list
    ])
    return xs, jnp.asarray(res)


def check_vs_oracle(got, oracle_rows, prime_list):
    """oracle_rows: [k][n] ints for batch row 0 comparison per batch."""
    for i in range(len(prime_list)):
        np.testing.assert_array_equal(
            np.asarray(got)[i], np.array(oracle_rows[i], dtype=np.uint32)
        )


def test_fast_base_conv_bit_exact():
    xs, res = rand_res(PARAMS.q_primes)
    cc = rns.make_base_conv(PARAMS.q_primes, PARAMS.bsk_primes)
    got = np.asarray(jax.jit(rns.fast_base_conv)(res, cc))
    for bi in range(B):
        want = oracle.fast_base_conv(
            [[x % p for x in xs[bi]] for p in PARAMS.q_primes],
            QB, PARAMS.bsk_primes)
        for ci in range(len(PARAMS.bsk_primes)):
            np.testing.assert_array_equal(got[ci, bi], np.array(want[ci], dtype=np.uint32))


def test_sm_mrq_bit_exact():
    xs, res = rand_res(PARAMS.q_primes)
    sc = rns.make_sm_mrq(PARAMS.q_primes, PARAMS.bsk_primes)
    got = np.asarray(jax.jit(rns.sm_mrq)(res, sc))
    for bi in range(B):
        want = oracle.sm_mrq(
            [[x % p for x in xs[bi]] for p in PARAMS.q_primes],
            QB, PARAMS.m_tilde, PARAMS.bsk_primes)
        for ci in range(len(PARAMS.bsk_primes)):
            np.testing.assert_array_equal(got[ci, bi], np.array(want[ci], dtype=np.uint32))


def test_fast_floor_bit_exact():
    # tensor-product-sized values: t*x for x < n*q^2
    q = PARAMS.q
    t = PARAMS.t
    xs = [[int(RNG.integers(0, 2**62)) * int(RNG.integers(0, 2**62)) % (N * q * q)
           for _ in range(N)] for _ in range(B)]
    tx = [[t * x for x in row] for row in xs]
    tx_q = jnp.asarray(np.stack([
        np.array([[v % int(p) for v in row] for row in tx], dtype=np.uint32)
        for p in PARAMS.q_primes]))
    tx_bsk = jnp.asarray(np.stack([
        np.array([[v % int(p) for v in row] for row in tx], dtype=np.uint32)
        for p in PARAMS.bsk_primes]))
    fc = rns.make_fast_floor(PARAMS.q_primes, PARAMS.bsk_primes)
    got = np.asarray(jax.jit(rns.fast_floor)(tx_q, tx_bsk, fc))
    for bi in range(B):
        want = oracle.fast_floor(
            [[t * x % p for x in xs[bi]] for p in PARAMS.q_primes],
            [[t * x % p for x in xs[bi]] for p in PARAMS.bsk_primes],
            QB, PARAMS.bsk_primes)
        for ci in range(len(PARAMS.bsk_primes)):
            np.testing.assert_array_equal(got[ci, bi], np.array(want[ci], dtype=np.uint32))


def test_fast_bconv_sk_bit_exact():
    Bprod = math.prod(PARAMS.aux_primes)
    xs = [[int(RNG.integers(0, 2**60)) % (Bprod // 4) for _ in range(N)]
          for _ in range(B)]
    x_bsk = jnp.asarray(np.stack([
        np.array([[x % int(p) for x in row] for row in xs], dtype=np.uint32)
        for p in PARAMS.bsk_primes]))
    sk = rns.make_sk(PARAMS.aux_primes, PARAMS.m_sk, PARAMS.q_primes)
    got = np.asarray(jax.jit(rns.fast_bconv_sk)(x_bsk, sk))
    for bi in range(B):
        want = oracle.fast_bconv_sk(
            [[x % p for x in xs[bi]] for p in PARAMS.bsk_primes],
            PARAMS.aux_primes, PARAMS.m_sk, PARAMS.q_primes)
        for ci in range(len(PARAMS.q_primes)):
            np.testing.assert_array_equal(got[ci, bi], np.array(want[ci], dtype=np.uint32))


def test_fast_bconv_sk_negative_values():
    """Signed inputs (centered lifts can be negative after fast_floor)."""
    Bprod = math.prod(PARAMS.aux_primes)
    xs = [[-((int(RNG.integers(0, 2**62)) << 62 | int(RNG.integers(0, 2**62)))
             % (Bprod // 4) + 1) for _ in range(N)] for _ in range(B)]
    x_bsk = jnp.asarray(np.stack([
        np.array([[x % int(p) for x in row] for row in xs], dtype=np.uint32)
        for p in PARAMS.bsk_primes]))
    sk = rns.make_sk(PARAMS.aux_primes, PARAMS.m_sk, PARAMS.q_primes)
    got = np.asarray(jax.jit(rns.fast_bconv_sk)(x_bsk, sk))
    for ci, c in enumerate(PARAMS.q_primes):
        for bi in range(B):
            want = np.array([x % int(c) for x in xs[bi]], dtype=np.uint32)
            np.testing.assert_array_equal(got[ci, bi], want)


def test_decrypt_scale_bit_exact():
    q, t = PARAMS.q, PARAMS.t
    delta = PARAMS.delta
    ms = [[int(RNG.integers(0, t)) for _ in range(N)] for _ in range(B)]
    noise_bound = min(q // (2 * t), 2**62)
    vs = [[int(RNG.integers(0, noise_bound)) - noise_bound // 2 for _ in range(N)]
          for _ in range(B)]
    xs = [[(delta * m + v) % q for m, v in zip(mr, vr)] for mr, vr in zip(ms, vs)]
    res = jnp.asarray(np.stack([
        np.array([[x % int(p) for x in row] for row in xs], dtype=np.uint32)
        for p in PARAMS.q_primes]))
    dc = rns.make_decrypt(PARAMS.q_primes, t, PARAMS.gamma)
    got = np.asarray(jax.jit(rns.decrypt_scale)(res, dc))
    for bi in range(B):
        want_o = oracle.decrypt_scale_gamma(
            [[x % p for x in xs[bi]] for p in PARAMS.q_primes], QB, t, PARAMS.gamma)
        want_direct = [oracle.round_div(t * x, q) % t for x in xs[bi]]
        assert want_o == want_direct
        np.testing.assert_array_equal(got[bi], np.array(want_o, dtype=np.uint32))


def test_mod_switch_bit_exact():
    xs, res = rand_res(PARAMS.q_primes)
    mc = rns.make_mod_switch(PARAMS.q_primes)
    got = np.asarray(jax.jit(rns.mod_switch_drop_last)(res, mc))
    for bi in range(B):
        want = oracle.mod_switch_drop_last(
            [[x % p for x in xs[bi]] for p in PARAMS.q_primes], PARAMS.q_primes)
        for ci in range(len(PARAMS.q_primes) - 1):
            np.testing.assert_array_equal(got[ci, bi], np.array(want[ci], dtype=np.uint32))


def test_host_crt_roundtrip():
    xs, res = rand_res(PARAMS.q_primes)
    back = rns.from_rns_host(np.asarray(res)[:, 0, :], PARAMS.q_primes)
    assert back == xs[0]
