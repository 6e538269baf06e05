"""Bit-exactness of the JAX compute path against the NumPy golden model.

This is stricter than the reference's decrypt-and-compare tests: every
intermediate (blind rotate output, extracted sample, keyswitch output, full
gates) must match the golden model uint32-for-uint32 (SURVEY.md §4 note).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from cufhe_jax import golden as G
from cufhe_jax import params as P
from cufhe_jax.ops import bootstrap as B
from cufhe_jax.ops import keys as K
from cufhe_jax.ops import keyswitch as KS
from cufhe_jax.ops import limbs as L
from cufhe_jax.ops import poly as PO

BACKENDS = ["conv", "toeplitz"]


def test_limb_roundtrip(rng):
    x = rng.integers(0, 1 << 32, size=(64,), dtype=np.uint64).astype(np.uint32)
    limbs = L.u32_to_signed_limbs(x)
    assert limbs.dtype == np.int8
    assert np.array_equal(L.signed_limbs_to_u32(limbs), x)


@pytest.mark.parametrize("backend", BACKENDS)
def test_negacyclic_conv_exact(backend, rng):
    """fwd->pointwise->inv vs naive CPU negacyclic convolution mod 2^32 — the
    reference's test_polynomial_mult_1024 setup with uint32 x small-int
    bounds."""
    N, I, k = 64, 4, 1
    dec = rng.integers(-32, 32, size=(3, I, N)).astype(np.int8)
    bk = rng.integers(0, 1 << 32, size=(I, k + 1, N),
                      dtype=np.uint64).astype(np.uint32)
    # golden: sum over I of negacyclic conv
    want = np.zeros((3, k + 1, N), dtype=np.uint32)
    for b in range(3):
        for o in range(k + 1):
            acc = np.zeros(N, np.int64)
            for i in range(I):
                acc += G.negacyclic_polymul(dec[b, i].astype(np.int64),
                                            bk[i, o].astype(np.int64))
            want[b, o] = acc.astype(np.uint32)

    limbs = L.u32_to_signed_limbs(bk)               # [I, k+1, N, L]
    if backend == "conv":
        filt = np.moveaxis(limbs, 3, 2).reshape(I, (k + 1) * L.NLIMBS, N)
        filt = np.moveaxis(filt, 0, 1)[..., ::-1]
        got = np.asarray(PO.negacyclic_conv_i8(
            jnp.asarray(dec), jnp.asarray(np.ascontiguousarray(filt)), k))
    else:
        nat = np.moveaxis(limbs, 3, 0)              # [L, I, k+1, N]
        got = np.asarray(PO.negacyclic_conv_toeplitz(
            jnp.asarray(dec), jnp.asarray(nat), k))
    assert np.array_equal(got, want)


def _batchify(*cts):
    return [jnp.asarray(np.stack(c, axis=0)) for c in cts]


@pytest.mark.parametrize("backend", BACKENDS)
def test_blind_rotate_bitexact(backend, tiny_key, rng):
    sk, ek = tiny_key
    p = sk.params
    keys = K.prepare_keys(ek)
    cts = [G.encrypt_bit(b, sk, rng) for b in (0, 1, 1)]
    want = np.stack([G.blind_rotate(c, p.lvl1.mu, ek) for c in cts])
    batch = jnp.asarray(np.stack(cts))
    got = np.asarray(B.blind_rotate(batch[:, :p.n0], batch[:, p.n0],
                                    p.lvl1.mu, keys, p, backend))
    assert np.array_equal(got, want)


def test_sample_extract_bitexact(tiny_key, rng):
    sk, _ = tiny_key
    p = sk.params.lvl1
    acc = rng.integers(0, 1 << 32, size=(3, p.k + 1, p.n),
                       dtype=np.uint64).astype(np.uint32)
    want = np.stack([G.sample_extract_index0(a, p) for a in acc])
    got = np.asarray(PO.sample_extract_index0(jnp.asarray(acc), p))
    assert np.array_equal(got, want)


def test_keyswitch_bitexact(tiny_key, rng):
    sk, ek = tiny_key
    p = sk.params
    keys = K.prepare_keys(ek)
    d1 = p.lvl1.k * p.lvl1.n
    tl = rng.integers(0, 1 << 32, size=(3, d1 + 1),
                      dtype=np.uint64).astype(np.uint32)
    want = np.stack([G.key_switch(t, ek) for t in tl])
    got = np.asarray(KS.key_switch(jnp.asarray(tl), keys.ksk_limbs, p))
    assert np.array_equal(got, want)
    # with fused pre-add
    other = rng.integers(0, 1 << 32, size=(3, d1 + 1),
                         dtype=np.uint64).astype(np.uint32)
    off = (-p.lvl1.mu) % (1 << 32)
    want = np.stack([G.key_switch(t, ek, pre=(1, -1, off, o))
                     for t, o in zip(tl, other)])
    u = lambda x: jnp.uint32(x % (1 << 32))
    got = np.asarray(KS.key_switch(jnp.asarray(tl), keys.ksk_limbs, p,
                                   pre=(u(1), u(-1), u(off),
                                        jnp.asarray(other))))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["nand", "xor", "mux"])
def test_gate_lvl0_bitexact_and_correct(backend, name, tiny_key, rng):
    sk, ek = tiny_key
    p = sk.params
    keys = K.prepare_keys(ek)
    bits0, bits1, bitsc = [0, 1, 0, 1], [0, 0, 1, 1], [0, 1, 1, 0]
    c0 = [G.encrypt_bit(b, sk, rng) for b in bits0]
    c1 = [G.encrypt_bit(b, sk, rng) for b in bits1]
    if name == "mux":
        cc = [G.encrypt_bit(b, sk, rng) for b in bitsc]
        want = np.stack([G.mux_lvl0(c, a, b, ek)
                         for c, a, b in zip(cc, c0, c1)])
        got = np.asarray(B.mux_lvl0(*_batchify(cc, c0, c1), keys, p,
                                    backend=backend))
        expect = [a if c else b for c, a, b in zip(bitsc, bits0, bits1)]
    else:
        want = np.stack([G.gate_lvl0(name, a, b, ek)
                         for a, b in zip(c0, c1)])
        got = np.asarray(B.gate_lvl0(G.GATE_CONSTANTS[name],
                                     *_batchify(c0, c1), keys, p,
                                     backend=backend))
        expect = [G.PLAIN_GATES[name](a, b) for a, b in zip(bits0, bits1)]
    assert np.array_equal(got, want)
    dec = [G.decrypt_bit(g, sk) for g in got]
    assert dec == expect


@pytest.mark.parametrize("name", ["nand", "orny"])
def test_gate_lvl1_bitexact(name, tiny_key, rng):
    sk, ek = tiny_key
    p = sk.params
    keys = K.prepare_keys(ek)
    bits0, bits1 = [0, 1, 0, 1], [0, 0, 1, 1]
    c0 = [G.encrypt_bit(b, sk, rng, level=1) for b in bits0]
    c1 = [G.encrypt_bit(b, sk, rng, level=1) for b in bits1]
    want = np.stack([G.gate_lvl1(name, a, b, ek) for a, b in zip(c0, c1)])
    got = np.asarray(B.gate_lvl1(G.GATE_CONSTANTS[name], *_batchify(c0, c1),
                                 keys, p))
    assert np.array_equal(got, want)
    assert [G.decrypt_bit(g, sk, level=1) for g in got] == \
        [G.PLAIN_GATES[name](a, b) for a, b in zip(bits0, bits1)]


def test_mux_lvl1_and_nmux_bitexact(tiny_key, rng):
    sk, ek = tiny_key
    p = sk.params
    keys = K.prepare_keys(ek)
    cc = [G.encrypt_bit(b, sk, rng, level=1) for b in (0, 1)]
    ca = [G.encrypt_bit(1, sk, rng, level=1) for _ in (0, 1)]
    cb = [G.encrypt_bit(0, sk, rng, level=1) for _ in (0, 1)]
    for negate in (False, True):
        want = np.stack([G.mux_lvl1(c, a, b, ek, negate=negate)
                         for c, a, b in zip(cc, ca, cb)])
        got = np.asarray(B.mux_lvl1(*_batchify(cc, ca, cb), keys, p,
                                    negate=negate))
        assert np.array_equal(got, want)


def test_cmux_bitexact(tiny_key, rng):
    sk, ek = tiny_key
    p = sk.params
    lp = p.lvl1
    for sel in (0, 1):
        tg = G.trgsw_encrypt(sel, lp, sk.lvl1, rng)
        c1 = G.trlwe_encrypt_zero(lp, sk.lvl1, rng)
        c0 = G.trlwe_encrypt_zero(lp, sk.lvl1, rng)
        want = G.cmux(tg, c1, c0, lp)[None]
        dev = K.prepare_trgsw(tg, p)
        got = np.asarray(B.cmux(dev, jnp.asarray(c1[None]),
                                jnp.asarray(c0[None]), p))
        assert np.array_equal(got, want)


def test_refresh_and_not_bitexact(tiny_key, rng):
    sk, ek = tiny_key
    p = sk.params
    keys = K.prepare_keys(ek)
    tr = G.trlwe_encrypt_zero(p.lvl1, sk.lvl1, rng)
    want = G.refresh(tr, ek)[None]
    got = np.asarray(B.refresh(jnp.asarray(tr[None]), keys, p))
    assert np.array_equal(got, want)
    ct = G.encrypt_bit(1, sk, rng)
    assert np.array_equal(np.asarray(B.not_gate(jnp.asarray(ct[None])))[0],
                          G.not_gate(ct))


def test_bg10_two_limb_digit_split_gate(rng):
    """USE_80BIT_SECURITY-style Bgbit=10 (Bg=1024): gadget digits exceed
    int8 and split into two balanced limbs (decomp_digit_limb_plan) — the
    conv backend must stay bit-exact vs the golden model."""
    p = P.GateParams(
        name="tiny-bg10-insecure-test",
        lvl0=P.LweParams(n=12, k=1, alpha=0.0, mu=1 << 29),
        lvl1=P.TrlweParams(nbit=6, k=1, l=2, Bgbit=10, alpha=0.0,
                           mu=1 << 29),
        ks=P.KeySwitchParams(t=4, basebit=2),
    )
    sk = G.keygen(p, seed=40)
    ek = G.make_eval_key(sk, seed=41)
    keys = K.prepare_keys(ek, backends=("conv",))
    bits0, bits1 = [0, 1, 0, 1], [0, 0, 1, 1]
    c0 = [G.encrypt_bit(b, sk, rng) for b in bits0]
    c1 = [G.encrypt_bit(b, sk, rng) for b in bits1]
    want = np.stack([G.gate_lvl0("nand", a, b, ek) for a, b in zip(c0, c1)])
    got = np.asarray(B.gate_lvl0(G.GATE_CONSTANTS["nand"],
                                 jnp.asarray(np.stack(c0)),
                                 jnp.asarray(np.stack(c1)), keys, p,
                                 backend="conv"))
    assert np.array_equal(got, want)
    assert [G.decrypt_bit(g, sk) for g in got] == \
        [1 - (a & b) for a, b in zip(bits0, bits1)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_programmable_bootstrap_bitexact(backend, tiny_key, rng):
    """Custom-test-vector bootstrap (PBS) vs the golden model, and its
    constant-mu special case vs the plain bootstrap — uint32-exact."""
    sk, ek = tiny_key
    p = sk.params
    keys = K.prepare_keys(ek)
    cts = [G.encrypt_bit(b, sk, rng) for b in (0, 1, 1)]
    batch = jnp.asarray(np.stack(cts))
    tv = rng.integers(0, 1 << 32, p.lvl1.n,
                      dtype=np.uint64).astype(np.uint32)
    want = np.stack([G.programmable_bootstrap(c, tv, ek) for c in cts])
    got = np.asarray(B.programmable_bootstrap(batch, jnp.asarray(tv),
                                              keys, p, backend))
    assert np.array_equal(got, want)
    # tv = const mu reduces exactly to the plain bootstrap
    tv_mu = np.full(p.lvl1.n, p.lvl1.mu, dtype=np.uint32)
    ref = np.asarray(B.bootstrap_tlwe2trlwe(batch, p.lvl1.mu, keys, p,
                                            backend))
    via_tv = np.asarray(B.pbs_tlwe2trlwe(batch, jnp.asarray(tv_mu), keys,
                                         p, backend))
    assert np.array_equal(ref, via_tv)

