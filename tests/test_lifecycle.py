"""Key memory lifecycle: explicit device-key release / re-preparation /
preset swap (the DeleteBootstrappingKeyNTT + DeleteKeySwitchingKey
analogue, /root/reference/include/bootstrap_gpu.cuh:50-165 and
include/keyswitch_gpu.cuh:190-196 — the reference can free per-GPU key
buffers; a long-lived server here must be able to do the same without
waiting for Python GC)."""
import numpy as np
import pytest

import cufhe_jax.params as P
from cufhe_jax import golden as G
from cufhe_jax.models import Context, decrypt_bits, encrypt_bits


@pytest.fixture(scope="module")
def keyed_bits():
    sk = G.keygen(P.TINY, seed=0)
    ek = G.make_eval_key(sk, seed=1)
    rng = np.random.default_rng(5)
    bits0 = rng.integers(0, 2, 16)
    bits1 = rng.integers(0, 2, 16)
    a = encrypt_bits(bits0, sk, np.random.default_rng(6))
    b = encrypt_bits(bits1, sk, np.random.default_rng(7))
    return sk, ek, bits0, bits1, a, b


def _nand_ref(bits0, bits1):
    return 1 - (bits0 & bits1)


def test_release_and_reprepare_roundtrip(keyed_bits):
    sk, ek, bits0, bits1, a, b = keyed_bits
    ctx = Context(ek, backend="conv")
    before = decrypt_bits(ctx.nand(a, b), sk)
    assert np.array_equal(before, _nand_ref(bits0, bits1))

    ctx.release_keys(("conv",))
    assert ctx.keys.bk_filters.size == 0
    # KSK survives a selective release
    assert ctx.keys.ksk_limbs.size > 0

    ctx.prepare_backend(ek, "conv")
    after = decrypt_bits(ctx.nand(a, b), sk)
    assert np.array_equal(after, before)  # bit-identical round trip


def test_full_release_frees_everything(keyed_bits):
    sk, ek, *_ , a, b = keyed_bits
    ctx = Context(ek, backend="conv")
    ctx.release_keys()
    for name in ("bk_filters", "bk_limbs", "ksk_limbs", "ksk_limbs_sei",
                 "bk_ntt", "bk_ntt_shoup"):
        assert getattr(ctx.keys, name).size == 0, name
    # full restore (KSK re-materialized alongside the backend keys)
    ctx.prepare_backend(ek, "conv")
    assert ctx.keys.ksk_limbs.size > 0
    out = decrypt_bits(ctx.nand(a, b), sk)
    assert out.shape == (16,)


def test_released_buffers_are_deleted(keyed_bits):
    _, ek, *_ = keyed_bits
    ctx = Context(ek, backend="conv")
    buf = ctx.keys.bk_filters
    ctx.release_keys(("conv",))
    with pytest.raises(RuntimeError):
        np.asarray(buf)  # the device buffer itself was freed, not just
        # dereferenced


def test_unknown_backend_rejected(keyed_bits):
    _, ek, *_ = keyed_bits
    ctx = Context(ek, backend="conv")
    with pytest.raises(ValueError, match="unknown backend"):
        ctx.release_keys(("definitely-not-a-backend",))


def test_reinitialize_preset_swap(keyed_bits):
    sk, ek, bits0, bits1, a, b = keyed_bits
    ctx = Context(ek, backend="conv")
    # swap to a different parameter set (k=2 CONCRETE-shaped TINY)
    sk2 = G.keygen(P.TINY_K2, seed=2)
    ek2 = G.make_eval_key(sk2, seed=3)
    ctx.reinitialize(ek2, backend="conv")
    assert ctx.params is ek2.params
    rng = np.random.default_rng(8)
    b0 = rng.integers(0, 2, 8)
    b1 = rng.integers(0, 2, 8)
    x = encrypt_bits(b0, sk2, np.random.default_rng(9))
    y = encrypt_bits(b1, sk2, np.random.default_rng(10))
    got = decrypt_bits(ctx.nand(x, y), sk2)
    assert np.array_equal(got, _nand_ref(b0, b1))
    # and back to the original set
    ctx.reinitialize(ek, backend="conv")
    got = decrypt_bits(ctx.nand(a, b), sk)
    assert np.array_equal(got, _nand_ref(bits0, bits1))


def test_mesh_context_release(keyed_bits):
    sk, ek, bits0, bits1, a, b = keyed_bits
    from cufhe_jax.parallel.mesh import data_mesh
    mesh = data_mesh()
    ctx = Context(ek, backend="conv", mesh=mesh)
    before = decrypt_bits(ctx.nand(a, b), sk)
    ctx.release_keys(("conv",))
    assert ctx.keys.bk_filters.size == 0
    ctx.prepare_backend(ek, "conv")
    after = decrypt_bits(ctx.nand(a, b), sk)
    assert np.array_equal(after, before)
