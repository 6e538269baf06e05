"""v1-style compatibility surface: the original cuFHE API shape.

The reference's historical API (documented by its stale tests,
test_api_gpu.cu:84-118: SetSeed / KeyGen / PriKey / PubKey / Ptxt / Ctxt /
Encrypt / Decrypt / Synchronize + capitalized gate functions) predates the
TFHEpp-based Initialize(ek) flow but is the shape much existing user code
was written against. This module provides that surface over the modern
Context/golden machinery so such code ports mechanically.

Scalar Ctxt objects here wrap a batch-of-1; for throughput use the batched
`cufhe_jax.models` API directly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import golden as G
from . import rng as rng_mod
from .params import DEFAULT, GateParams
from .models.api import Context, Ctxt as _BatchCtxt
from .runtime.stream import Stream, synchronize as _synchronize

# None = "SetSeed never called": key/encryption randomness comes from the
# OS CSPRNG (rng.SecureRandom). SetSeed(seed) switches to a reproducible
# PCG64 stream, matching the v1 API's deterministic-testing intent.
_rng: Optional[rng_mod.RngLike] = None
_ctx: Optional[Context] = None


class Ptxt:
    """Plaintext bit (Ptxt, test_api_gpu.cu usage; kPtxtSpace = 2)."""
    kPtxtSpace = 2

    def __init__(self, message: int = 0):
        self.message_ = int(message) % self.kPtxtSpace

    # the reference allows `pt = value` semantics via assignment; emulate
    # with a helper
    def set(self, message: int) -> "Ptxt":
        self.message_ = int(message) % self.kPtxtSpace
        return self


class PriKey:
    """Private (secret) key holder (PriKey)."""

    def __init__(self, params: GateParams = DEFAULT):
        self.params = params
        self.sk: Optional[G.SecretKey] = None


class PubKey:
    """Public evaluation key holder (PubKey = bootstrapping + keyswitch key)."""

    def __init__(self, params: GateParams = DEFAULT):
        self.params = params
        self.ek: Optional[G.EvalKey] = None


class Ctxt:
    """Single-bit ciphertext (Ctxt<lvl0param>); wraps a [1, n0+1] batch."""

    def __init__(self):
        self._c: Optional[_BatchCtxt] = None


def SetSeed(seed: Optional[int] = None) -> None:
    """Switch to a reproducible RNG stream (SetSeed, test_api_gpu.cu:84).
    SetSeed() with no argument restores the secure default."""
    global _rng
    _rng = None if seed is None else np.random.default_rng(seed)


def PriKeyGen(pri_key: PriKey, seed: Optional[int] = None) -> None:
    if seed is None and _rng is not None:
        seed = int(_rng.integers(1 << 31))
    pri_key.sk = G.keygen(pri_key.params, seed=seed)


def PubKeyGen(pub_key: PubKey, pri_key: PriKey) -> None:
    assert pri_key.sk is not None, "run PriKeyGen first"
    seed = int(_rng.integers(1 << 31)) if _rng is not None else None
    pub_key.ek = G.make_eval_key(pri_key.sk, seed=seed)
    pub_key.params = pri_key.params


def KeyGen(pub_key: PubKey, pri_key: PriKey) -> None:
    """KeyGen(pub, pri) (test_api_gpu.cu:95)."""
    PriKeyGen(pri_key)
    PubKeyGen(pub_key, pri_key)


def Initialize(pub_key: PubKey, backend: str = "auto") -> None:
    """Upload/convert the evaluation key (Initialize, cufhe_gpu.cuh:57)."""
    global _ctx
    assert pub_key.ek is not None, "run KeyGen/PubKeyGen first"
    _ctx = Context(pub_key.ek, backend=backend)


def CleanUp() -> None:
    """Release server-side key material (CleanUp, cufhe_gpu.cuh:62).
    Device key buffers are freed eagerly, not left to GC."""
    global _ctx
    if _ctx is not None:
        _ctx.release_keys()
    _ctx = None


def Synchronize() -> None:
    _synchronize()


def Encrypt(ct: Ctxt, pt: Ptxt, pri_key: PriKey) -> None:
    from .models.api import encrypt_bits
    assert pri_key.sk is not None
    ct._c = encrypt_bits([pt.message_], pri_key.sk,
                         rng_mod.resolve_rng(rng=_rng))


def Decrypt(pt: Ptxt, ct: Ctxt, pri_key: PriKey) -> None:
    from .models.api import decrypt_bits
    assert pri_key.sk is not None and ct._c is not None
    pt.message_ = int(decrypt_bits(ct._c, pri_key.sk)[0])


def _gate2(name):
    def fn(out: Ctxt, in0: Ctxt, in1: Ctxt,
           stream: Optional[Stream] = None) -> None:
        assert _ctx is not None, "call Initialize(pub_key) first"
        # stream= forwards to Context.gate so work is PLACED on the
        # stream's device (cufhe_gpu.cuh:152-189 semantics), not merely
        # recorded; Context.gate also records the output on the stream
        out._c = _ctx.gate(name, in0._c, in1._c, stream=stream)
    fn.__name__ = name.capitalize()
    return fn


Nand = _gate2("nand")
Or = _gate2("or")
OrYN = _gate2("oryn")
OrNY = _gate2("orny")
And = _gate2("and")
AndYN = _gate2("andyn")
AndNY = _gate2("andny")
Xor = _gate2("xor")
Xnor = _gate2("xnor")
Nor = _gate2("nor")


def Not(out: Ctxt, in0: Ctxt, stream: Optional[Stream] = None) -> None:
    assert _ctx is not None
    out._c = _ctx.not_(in0._c, stream=stream)


def Copy(out: Ctxt, in0: Ctxt, stream: Optional[Stream] = None) -> None:
    assert _ctx is not None
    out._c = _ctx.copy(in0._c, stream=stream)


def Mux(out: Ctxt, inc: Ctxt, in1: Ctxt, in0: Ctxt,
        stream: Optional[Stream] = None) -> None:
    assert _ctx is not None
    out._c = _ctx.mux(inc._c, in1._c, in0._c, stream=stream)


def NMux(out: Ctxt, inc: Ctxt, in1: Ctxt, in0: Ctxt,
         stream: Optional[Stream] = None) -> None:
    assert _ctx is not None
    out._c = _ctx.nmux(inc._c, in1._c, in0._c, stream=stream)
