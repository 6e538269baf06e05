"""Key/ciphertext serialization roundtrips (checkpoint/resume of evaluation
material — the reference bundles cereal via TFHEpp but never calls it;
SURVEY.md §5)."""
import numpy as np
import pytest

from cufhe_jax import golden as G
from cufhe_jax import params as P
from cufhe_jax.models import Context, decrypt_bits, encrypt_bits
from cufhe_jax.utils import serialization as S


def test_eval_key_roundtrip(tmp_path, tiny_key):
    sk, ek = tiny_key
    p = str(tmp_path / "ek.npz")
    S.save_eval_key(p, ek)
    ek2 = S.load_eval_key(p)
    assert ek2.params == ek.params
    assert np.array_equal(ek2.bk, ek.bk)
    assert np.array_equal(ek2.ksk, ek.ksk)


def test_secret_key_roundtrip(tmp_path, tiny_key):
    sk, _ = tiny_key
    p = str(tmp_path / "sk.npz")
    S.save_secret_key(p, sk)
    sk2 = S.load_secret_key(p)
    assert sk2.params == sk.params
    assert np.array_equal(sk2.lvl0, sk.lvl0)
    assert np.array_equal(sk2.lvl1, sk.lvl1)


def test_server_without_secret_key(tmp_path, tiny_key, rng):
    """The server-side flow: a process that only ever sees the EvalKey file
    evaluates gates on ciphertexts serialized by the client."""
    sk, ek = tiny_key
    ekp = str(tmp_path / "ek.npz")
    ctp = str(tmp_path / "ct.npz")
    S.save_eval_key(ekp, ek)
    bits = np.array([0, 1, 1, 0])
    S.save_ciphertexts(ctp, np.asarray(encrypt_bits(bits, sk, rng).data), 0)

    # "server": loads public material only
    ek2 = S.load_eval_key(ekp)
    data, level = S.load_ciphertexts(ctp)
    ctx = Context(ek2)
    from cufhe_jax.models.api import Ctxt
    import jax.numpy as jnp
    ct = Ctxt(jnp.asarray(data), level)
    out = ctx.nand(ct, ct)

    # "client": decrypts
    assert np.array_equal(decrypt_bits(out, sk), 1 - (bits & bits))


def test_wrong_kind_rejected(tmp_path, tiny_key):
    sk, ek = tiny_key
    p = str(tmp_path / "x.npz")
    S.save_eval_key(p, ek)
    with pytest.raises(AssertionError, match="not a secret key"):
        S.load_secret_key(p)


def test_params_fingerprint_mismatch_rejected(tmp_path, tiny_key):
    """A key file whose preset's parameter VALUES have since changed must
    refuse to load (the round-2 key-cache trap: caches keyed by preset
    name silently reused keys across gadget-parameter changes)."""
    import numpy as np
    sk, ek = tiny_key
    path = str(tmp_path / "ek.npz")
    S.save_eval_key(path, ek)
    # simulate a changed preset: rewrite the stored fingerprint
    z = dict(np.load(path, allow_pickle=False))
    z["fingerprint"] = np.str_("0" * 16)
    np.savez_compressed(path, **z)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        S.load_eval_key(path)
    # files from before fingerprinting (no field) still load
    z.pop("fingerprint")
    np.savez_compressed(path, **z)
    ek2 = S.load_eval_key(path)
    assert np.array_equal(ek2.bk, ek.bk)
