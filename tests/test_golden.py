"""Golden-model self-consistency: every gate decrypts to its truth table.

This is the JAX analogue of the reference's decrypt-and-compare oracle tests
(test/test_util.h:8-95, test/plain.h:10-69) run against the pure-NumPy model.
"""
import numpy as np
import pytest

from cufhe_jax import golden as G

TWO_INPUT = ["nand", "nor", "xnor", "and", "or", "xor",
             "andny", "andyn", "orny", "oryn"]


@pytest.mark.parametrize("name", TWO_INPUT)
def test_gate_lvl0(name, tiny_key, rng):
    sk, ek = tiny_key
    for a in (0, 1):
        for b in (0, 1):
            c0 = G.encrypt_bit(a, sk, rng, level=0)
            c1 = G.encrypt_bit(b, sk, rng, level=0)
            out = G.gate_lvl0(name, c0, c1, ek)
            assert G.decrypt_bit(out, sk, level=0) == \
                G.PLAIN_GATES[name](a, b), (name, a, b)


@pytest.mark.parametrize("name", ["nand", "xor", "andny"])
def test_gate_lvl1(name, tiny_key, rng):
    sk, ek = tiny_key
    for a in (0, 1):
        for b in (0, 1):
            c0 = G.encrypt_bit(a, sk, rng, level=1)
            c1 = G.encrypt_bit(b, sk, rng, level=1)
            out = G.gate_lvl1(name, c0, c1, ek)
            assert G.decrypt_bit(out, sk, level=1) == \
                G.PLAIN_GATES[name](a, b), (name, a, b)


def test_mux_nmux_lvl0(tiny_key, rng):
    sk, ek = tiny_key
    for c in (0, 1):
        for a in (0, 1):
            for b in (0, 1):
                cc = G.encrypt_bit(c, sk, rng)
                ca = G.encrypt_bit(a, sk, rng)
                cb = G.encrypt_bit(b, sk, rng)
                want = a if c else b
                assert G.decrypt_bit(G.mux_lvl0(cc, ca, cb, ek), sk) == want
                assert G.decrypt_bit(
                    G.mux_lvl0(cc, ca, cb, ek, negate=True), sk) == 1 - want


def test_mux_lvl1(tiny_key, rng):
    sk, ek = tiny_key
    for c in (0, 1):
        cc = G.encrypt_bit(c, sk, rng, level=1)
        ca = G.encrypt_bit(1, sk, rng, level=1)
        cb = G.encrypt_bit(0, sk, rng, level=1)
        want = 1 if c else 0
        assert G.decrypt_bit(G.mux_lvl1(cc, ca, cb, ek), sk, level=1) == want
        assert G.decrypt_bit(G.mux_lvl1(cc, ca, cb, ek, negate=True),
                             sk, level=1) == 1 - want


def test_not_copy(tiny_key, rng):
    sk, ek = tiny_key
    for a in (0, 1):
        c = G.encrypt_bit(a, sk, rng)
        assert G.decrypt_bit(G.not_gate(c), sk) == 1 - a
        assert G.decrypt_bit(G.copy_gate(c), sk) == a


def test_cmux(tiny_key, rng):
    sk, ek = tiny_key
    p = sk.params.lvl1
    mu = np.uint32(p.mu)
    for sel in (0, 1):
        tg = G.trgsw_encrypt(sel, p, sk.lvl1, rng)
        m1 = np.zeros((p.k + 1, p.n), np.uint32)
        m1[p.k, :] = mu
        m0 = np.zeros_like(m1)
        m0[p.k, :] = np.uint32((-int(mu)) % (1 << 32))
        r = G.cmux(tg, m1, m0, p)
        ph = G.trlwe_phase(r, p, sk.lvl1)
        assert np.all((ph.astype(np.int32) > 0) == bool(sel))


def test_refresh_and_k2_gates(tiny_k2_key, rng):
    sk, ek = tiny_k2_key
    # k=2 (CONCRETE-style) parameter order must also work
    for a in (0, 1):
        for b in (0, 1):
            c0 = G.encrypt_bit(a, sk, rng)
            c1 = G.encrypt_bit(b, sk, rng)
            out = G.gate_lvl0("nand", c0, c1, ek)
            assert G.decrypt_bit(out, sk) == 1 - (a & b)
    # refresh keeps the message
    p = sk.params.lvl1
    tr = G.trlwe_encrypt_zero(p, sk.lvl1, rng)
    tr[p.k, 0] = np.uint32((int(tr[p.k, 0]) + p.mu) % (1 << 32))
    r = G.refresh(tr, ek)
    ph = G.trlwe_phase(r, p, sk.lvl1)
    assert ph[0].astype(np.int32) > 0


def test_negacyclic_polymul_matches_naive(rng):
    n = 64
    a = rng.integers(-32, 32, n).astype(np.int64)
    b = rng.integers(0, 1 << 32, n).astype(np.int64)
    ref = np.zeros(n, np.int64)
    for i in range(n):
        for j in range(n):
            if i + j < n:
                ref[i + j] += a[i] * b[j]
            else:
                ref[i + j - n] -= a[i] * b[j]
    assert np.array_equal(G.negacyclic_polymul(a, b), ref)
