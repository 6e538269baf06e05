"""NTT layer (RAINTT small-modulus instantiation) — mirrors the reference's
test_polynomial_mult_1024: forward -> pointwise -> inverse vs a naive O(n^2)
CPU negacyclic convolution (reference test_polynomial_mult_1024.cu:49-250),
plus discretization-switching error bounds (ntt_small_modulus.cuh:40-73).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from cufhe_jax.ops import ntt


def naive_negacyclic_mod(a, b, p):
    """O(n^2) negacyclic convolution mod p (the reference's CPU oracle)."""
    n = len(a)
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                out[k] = (out[k] + int(a[i]) * int(b[j])) % p
            else:
                out[k - n] = (out[k - n] - int(a[i]) * int(b[j])) % p
    return out.astype(np.uint32)


@pytest.mark.parametrize("nbit", [4, 10])
def test_ntt_roundtrip(nbit, rng):
    N = 1 << nbit
    tab = ntt.make_tables(nbit)
    a = jnp.asarray(rng.integers(0, ntt.P, (3, N)).astype(np.uint32))
    back = np.asarray(ntt.ntt_inverse(ntt.ntt_forward(a, tab), tab))
    assert np.array_equal(back, np.asarray(a))


def test_ntt_polynomial_mult_vs_naive(rng):
    """Exact mod-p product for bounded inputs (n*max_a*max_b < p — the
    reference's bound derivation, test_polynomial_mult_1024.cu:33-39)."""
    nbit, N = 10, 1024
    tab = ntt.make_tables(nbit)
    # 1024 * 2^9 * 2^9 < p ~ 2^29.3
    for _ in range(3):
        a = rng.integers(0, 1 << 9, N).astype(np.uint32)
        b = rng.integers(0, 1 << 9, N).astype(np.uint32)
        b_ntt = np.asarray(ntt.ntt_forward(jnp.asarray(b)[None], tab))[0]
        got = np.asarray(ntt.negacyclic_mul_mod_p(
            jnp.asarray(a)[None], jnp.asarray(b_ntt)[None],
            jnp.asarray(ntt.shoup_precompute(b_ntt))[None], tab))[0]
        want = naive_negacyclic_mod(a, b, ntt.P)
        assert np.array_equal(got, want)


def test_mulhi_and_shoup_exactness(rng):
    a = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    got = np.asarray(ntt._mulhi_u32(jnp.asarray(a), jnp.asarray(b)))
    want = ((a.astype(np.uint64) * b.astype(np.uint64)) >> 32).astype(
        np.uint32)
    assert np.array_equal(got, want)
    w = rng.integers(0, ntt.P, 1000).astype(np.uint32)
    x = rng.integers(0, ntt.P, 1000).astype(np.uint32)
    ws = ntt.shoup_precompute(w)
    got = np.asarray(ntt.mulmod_shoup(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(ws)))
    want = ((x.astype(np.uint64) * w.astype(np.uint64)) % ntt.P).astype(
        np.uint32)
    assert np.array_equal(got, want)


def test_torus_discretization_switching(rng):
    """Torus -> mod-p -> torus roundtrip error <= ceil(2^32/(2p))
    (the RAINTT discretization, ntt_small_modulus.cuh:40-73)."""
    a = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    m = np.asarray(ntt.torus_to_mod(jnp.asarray(a)))
    want = np.asarray(
        ((a.astype(np.uint64) * ntt.P + (1 << 31)) >> 32) % ntt.P,
        dtype=np.uint32)
    assert np.array_equal(m, want)
    back = ntt.mod_to_torus(m)
    diff = np.minimum(back - a, a - back)  # wrap-aware |difference|
    assert diff.max() <= (1 << 32) // (2 * ntt.P) + 1


def test_torus_polymul_via_small_modulus(rng):
    """Torus poly x small integer poly through the small-modulus pipeline:
    error vs exact mod-2^32 convolution bounded by N * max|b| * switch-step
    (the documented accuracy tradeoff of the reference's
    USE_SMALL_NTT_MODULUS mode)."""
    from cufhe_jax.golden import negacyclic_polymul
    nbit, N = 10, 1024
    tab = ntt.make_tables(nbit)
    a = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(-32, 32, N).astype(np.int64)
    b_p = (b % ntt.P).astype(np.uint32)
    b_ntt = np.asarray(ntt.ntt_forward(jnp.asarray(b_p)[None], tab))[0]
    a_m = ntt.torus_to_mod(jnp.asarray(a)[None])
    prod = np.asarray(ntt.ntt_inverse(ntt.pointwise_mul(
        ntt.ntt_forward(a_m, tab), jnp.asarray(b_ntt)[None],
        jnp.asarray(ntt.shoup_precompute(b_ntt))[None]), tab))[0]
    got = ntt.mod_to_torus(prod)
    want = negacyclic_polymul(a, b.astype(np.uint32))
    diff = np.minimum(got - want, want - got).astype(np.int64)
    bound = N * 32 * ((1 << 32) // ntt.P + 1)
    assert diff.max() <= bound


def test_mod_to_torus_jax_close(rng):
    """Device mod->torus conversion within 2 LSB of the exact division."""
    x = rng.integers(0, ntt.P, 8192).astype(np.uint32)
    got = np.asarray(ntt.mod_to_torus_jax(jnp.asarray(x)))
    want = ntt.mod_to_torus(x)
    diff = np.minimum(got - want, want - got)
    assert diff.max() <= 2


def test_ntt_forward_host_matches_device(rng):
    tab = ntt.make_tables(6)
    a = rng.integers(0, ntt.P, (5, 64)).astype(np.uint32)
    host = ntt.ntt_forward_host(a, tab)
    dev = np.asarray(ntt.ntt_forward(jnp.asarray(a), tab))
    assert np.array_equal(host, dev)


def test_ntt_backend_gate(tiny_key):
    """The USE_SMALL_NTT_MODULUS gate mode end to end: NAND through the
    'ntt' blind-rotate backend decrypts to the truth table and its phase
    stays within the discretization-noise envelope of the exact path
    (the reference tests this mode decrypt-only, test_gate_gpu.cc)."""
    from cufhe_jax import golden as G
    from cufhe_jax.ops import bootstrap as B
    from cufhe_jax.ops import keys as K

    # dedicated generator: the phase-envelope bound below is statistical
    # (two decorrelating noise paths), so this test must not move with
    # the session rng stream as the suite grows
    rng = np.random.default_rng(77)
    sk, ek = tiny_key
    p = sk.params
    keys = K.prepare_keys(ek, backends=("ntt",))
    bits0, bits1 = [0, 1, 0, 1], [0, 0, 1, 1]
    c0 = [G.encrypt_bit(b, sk, rng) for b in bits0]
    c1 = [G.encrypt_bit(b, sk, rng) for b in bits1]
    in0 = jnp.asarray(np.stack(c0))
    in1 = jnp.asarray(np.stack(c1))
    got = np.asarray(B.gate_lvl0(G.GATE_CONSTANTS["nand"], in0, in1, keys,
                                 p, backend="ntt"))
    dec = [G.decrypt_bit(g, sk) for g in got]
    assert dec == [1 - (a & b) for a, b in zip(bits0, bits1)]
    # phase distance to the exact path stays far inside the mu/2 margin
    # (TLWE masks legitimately diverge between paths; only the phase
    # b - <a, s> is comparable)
    want = np.stack([G.gate_lvl0("nand", a, b, ek)
                     for a, b in zip(c0, c1)])
    ph_g = np.array([G.tlwe_phase(g, sk.lvl0) for g in got], dtype=np.uint32)
    ph_w = np.array([G.tlwe_phase(w, sk.lvl0) for w in want],
                    dtype=np.uint32)
    diff = np.minimum(ph_g - ph_w, ph_w - ph_g).astype(np.int64)
    # The dominant term is TINY's own gadget-truncation noise (only
    # l*Bgbit = 12 bits kept -> ~2^24-25 per path) decorrelating between
    # the two paths once their accumulators diverge; the mod-p
    # discretization itself contributes only ~2^13 here. The max over the
    # batch is a ~2-sigma draw of that ~2^25-scale difference, so the
    # bound allows 2^27 — still 2x inside the mu/2 = 2^28 decision margin.
    assert diff.max() < (1 << 27), diff.max()
