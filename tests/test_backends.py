"""The resolved ("auto") blind-rotation path vs the golden model, and the
resolution rule itself.

"auto" picks its backend from the parameter shape alone, so these CPU
tests run the very path the GPU runs. The presets keep the shapes the
removed fused-kernel tests covered: N=128 and N=512, k=1 and k=2, Bg=64,
256 and 1024 (digit-limb split)."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cufhe_jax import golden as G
from cufhe_jax import params as P
from cufhe_jax.models import Context
from cufhe_jax.ops import bootstrap as B
from cufhe_jax.ops import keys as K

PRESETS = {
    "tiny_n128": (P.TINY_N128, 10),
    "tiny_k2": (P.TINY_K2_N128, 20),
    "bg10": (P.TINY_BG10, 30),
    "n512": (P.TINY_N512, 40),
    "bg10_n512": (P.TINY_BG10_N512, 50),
}


@pytest.fixture(scope="module")
def preset_keys():
    cache = {}

    def get(name):
        if name not in cache:
            params, seed = PRESETS[name]
            sk = G.keygen(params, seed=seed)
            ek = G.make_eval_key(sk, seed=seed + 1)
            keys = K.prepare_keys(ek, backends=(B.resolve_backend("auto",
                                                                  params),))
            cache[name] = (sk, ek, keys)
        return cache[name]
    return get


@pytest.mark.parametrize("op", ["nand", "xor", "mux", "pbs"])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_auto_path_bitexact(preset, op, preset_keys):
    sk, ek, keys = preset_keys(preset)
    p = sk.params
    rng = np.random.default_rng(zlib.crc32(f"{preset}/{op}".encode()))
    bits = rng.integers(0, 2, (3, 4))
    cts = [np.stack([G.encrypt_bit(int(v), sk, rng) for v in row])
           for row in bits]
    c0, c1, cc = (jnp.asarray(c) for c in cts)
    if op == "mux":
        want = np.stack([G.mux_lvl0(cts[2][i], cts[0][i], cts[1][i], ek)
                         for i in range(4)])
        got = B.mux_lvl0(cc, c0, c1, keys, p)
        plain = np.where(bits[2] == 1, bits[0], bits[1])
    elif op == "pbs":
        tv = rng.integers(0, 1 << 32, p.lvl1.n,
                          dtype=np.uint64).astype(np.uint32)
        want = np.stack([G.programmable_bootstrap(cts[0][i], tv, ek)
                         for i in range(4)])
        got = B.programmable_bootstrap(c0, jnp.asarray(tv), keys, p)
        plain = None
    else:
        want = np.stack([G.gate_lvl0(op, cts[0][i], cts[1][i], ek)
                         for i in range(4)])
        got = B.gate_lvl0(G.GATE_CONSTANTS[op], c0, c1, keys, p)
        plain = np.array([G.PLAIN_GATES[op](a, b)
                          for a, b in zip(bits[0], bits[1])])
    got = np.asarray(got)
    assert np.array_equal(got, want)
    if plain is not None:
        assert [G.decrypt_bit(g, sk) for g in got] == plain.tolist()


def test_auto_resolves_same_on_every_platform(monkeypatch):
    """The rule reads the parameter shape only: pretending to run on any
    platform leaves every preset's choice unchanged, and it is always an
    exact backend."""
    want = {name: B.resolve_backend("auto", p)
            for name, p in P.PRESETS.items()}
    assert set(want.values()) <= {"conv", "toeplitz"}
    for platform in ("cpu", "gpu", "cuda", "rocm"):
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert {name: B.resolve_backend("auto", p)
                for name, p in P.PRESETS.items()} == want
    for b in B.BACKENDS:
        assert B.resolve_backend(b, P.TFHEPP_128) == b


@pytest.mark.parametrize("backend", ["pallas", "pallas3", "mosaic"])
def test_removed_backend_raises(backend, tiny_key):
    _, ek = tiny_key
    with pytest.raises(ValueError, match="unknown backend"):
        Context(ek, backend=backend)
