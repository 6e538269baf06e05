"""Client-side CSPRNG policy (the USE_RANDEN analogue,
/root/reference/CMakeLists.txt:8): key generation and encryption must
default to OS-entropy randomness, never PCG64, unless a test explicitly
passes a seed."""
import numpy as np
import pytest

import cufhe_jax.params as P
from cufhe_jax import golden as G
from cufhe_jax import rng as R
from cufhe_jax.models.api import encrypt_bits, decrypt_bits


def test_integers_bounds_and_dtype():
    r = R.SecureRandom()
    x = r.integers(0, 2, size=1000, dtype=np.uint32)
    assert x.dtype == np.uint32 and x.min() >= 0 and x.max() <= 1
    # both values occur (2^-1000 flake odds)
    assert 0 in x and 1 in x
    y = r.integers(0, 1 << 32, size=100, dtype=np.uint64)
    assert y.dtype == np.uint64 and int(y.max()) < (1 << 32)
    z = r.integers(5, 17, size=500)
    assert z.min() >= 5 and z.max() < 17
    s = r.integers(1 << 31)
    assert np.isscalar(s) or s.shape == ()


def test_integers_non_pow2_uniform():
    r = R.SecureRandom()
    x = r.integers(0, 3, size=30000)
    counts = np.bincount(x, minlength=3)
    # each bucket within 6 sigma of 10000 (sigma ~ 81.6)
    assert np.all(np.abs(counts - 10000) < 500), counts


def test_normal_moments():
    r = R.SecureRandom()
    x = r.normal(0.0, 2.0, size=200000)
    assert abs(float(np.mean(x))) < 0.05
    assert abs(float(np.std(x)) - 2.0) < 0.05
    assert isinstance(r.normal(0.0, 1.0), float)


def test_unknown_method_raises():
    with pytest.raises(AttributeError):
        R.SecureRandom().shuffle([1, 2, 3])


def test_resolve_rng_policy():
    assert isinstance(R.resolve_rng(), R.SecureRandom)
    g = R.resolve_rng(seed=123)
    assert isinstance(g, np.random.Generator)
    assert g.integers(1 << 30) == np.random.default_rng(123).integers(1 << 30)
    marker = np.random.default_rng(0)
    assert R.resolve_rng(rng=marker) is marker


def test_default_keygen_never_uses_pcg64(monkeypatch):
    """The secure default path must not touch np.random.default_rng."""
    def boom(*a, **k):
        raise AssertionError("default path fell back to PCG64")
    monkeypatch.setattr(R.np.random, "default_rng", boom)
    sk = G.keygen(P.TINY)
    ek = G.make_eval_key(sk)
    ct = encrypt_bits([1, 0, 1], sk)
    assert ek.bk.shape[0] == P.TINY.lvl0.dim
    assert list(decrypt_bits(ct, sk)) == [1, 0, 1]


def test_default_keygen_nondeterministic():
    a = G.keygen(P.TINY)
    b = G.keygen(P.TINY)
    assert not np.array_equal(a.lvl0, b.lvl0) or \
        not np.array_equal(a.lvl1, b.lvl1)
    # seeded path stays reproducible for fixtures
    s1 = G.keygen(P.TINY, seed=7)
    s2 = G.keygen(P.TINY, seed=7)
    assert np.array_equal(s1.lvl0, s2.lvl0)
    assert np.array_equal(s1.lvl1, s2.lvl1)


def test_secure_encrypt_decrypt_roundtrip():
    """End-to-end on the secure path: noise distribution must still give
    correct decryptions."""
    sk = G.keygen(P.TINY)
    bits = list(np.random.default_rng(3).integers(0, 2, 64))
    ct = encrypt_bits(bits, sk)
    assert list(decrypt_bits(ct, sk)) == bits
