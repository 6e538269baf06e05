"""v1-compat API surface (the reference's original SetSeed/KeyGen/Encrypt/
Decrypt/gate shape, test_api_gpu.cu:84-190) ported mechanically."""
import numpy as np
import pytest

import cufhe_jax.compat as cf
from cufhe_jax import TINY


@pytest.fixture(scope="module")
def keys():
    cf.SetSeed(42)
    pri = cf.PriKey(TINY)
    pub = cf.PubKey(TINY)
    cf.KeyGen(pub, pri)
    cf.Initialize(pub)
    yield pri, pub
    cf.CleanUp()


def test_encrypt_decrypt_roundtrip(keys):
    pri, _ = keys
    for bit in (0, 1):
        pt, pt2, ct = cf.Ptxt(bit), cf.Ptxt(), cf.Ctxt()
        cf.Encrypt(ct, pt, pri)
        cf.Decrypt(pt2, ct, pri)
        assert pt2.message_ == bit


def test_gates_truth_tables(keys):
    pri, _ = keys
    cases = {
        cf.Nand: lambda a, b: 1 - (a & b),
        cf.And: lambda a, b: a & b,
        cf.Or: lambda a, b: a | b,
        cf.Xor: lambda a, b: a ^ b,
        cf.AndYN: lambda a, b: a & (1 - b),
        cf.OrNY: lambda a, b: (1 - a) | b,
    }
    st = cf.Stream()
    for gate, oracle in cases.items():
        for a in (0, 1):
            for b in (0, 1):
                c0, c1, out = cf.Ctxt(), cf.Ctxt(), cf.Ctxt()
                cf.Encrypt(c0, cf.Ptxt(a), pri)
                cf.Encrypt(c1, cf.Ptxt(b), pri)
                gate(out, c0, c1, st)
                cf.Synchronize()
                pt = cf.Ptxt()
                cf.Decrypt(pt, out, pri)
                assert pt.message_ == oracle(a, b), (gate.__name__, a, b)


def test_mux_not_copy(keys):
    pri, _ = keys
    for s, a, b in [(0, 1, 0), (1, 1, 0), (0, 0, 1), (1, 0, 1)]:
        cs, ca, cb, out = cf.Ctxt(), cf.Ctxt(), cf.Ctxt(), cf.Ctxt()
        cf.Encrypt(cs, cf.Ptxt(s), pri)
        cf.Encrypt(ca, cf.Ptxt(a), pri)
        cf.Encrypt(cb, cf.Ptxt(b), pri)
        cf.Mux(out, cs, ca, cb)
        pt = cf.Ptxt()
        cf.Decrypt(pt, out, pri)
        assert pt.message_ == (a if s else b)
    n, c = cf.Ctxt(), cf.Ctxt()
    cf.Encrypt(c, cf.Ptxt(1), pri)
    cf.Not(n, c)
    pt = cf.Ptxt()
    cf.Decrypt(pt, n, pri)
    assert pt.message_ == 0


def test_compat_gates_run_on_stream_devices(keys):
    """The v1 surface must PLACE work on a stream's device (mirrors
    test_runtime.py::test_streams_execute_on_their_devices) — round-2's
    compat shim recorded outputs on the stream but ran everything on
    device 0."""
    import jax
    pri, _ = keys
    devs = jax.devices()
    assert len(devs) >= 2
    st0, st1 = cf.Stream(device=devs[0]), cf.Stream(device=devs[1])
    a, b = cf.Ctxt(), cf.Ctxt()
    cf.Encrypt(a, cf.Ptxt(1), pri)
    cf.Encrypt(b, cf.Ptxt(1), pri)
    o0, o1, o2 = cf.Ctxt(), cf.Ctxt(), cf.Ctxt()
    cf.Nand(o0, a, b, st0)
    cf.Nand(o1, a, b, st1)
    cf.Not(o2, o1, st1)
    assert o0._c.data.devices() == {devs[0]}
    assert o1._c.data.devices() == {devs[1]}
    assert o2._c.data.devices() == {devs[1]}
    cf.Synchronize()
    for o, want in ((o0, 0), (o1, 0), (o2, 1)):
        pt = cf.Ptxt()
        cf.Decrypt(pt, o, pri)
        assert pt.message_ == want
