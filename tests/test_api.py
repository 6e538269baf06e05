"""Public API + mesh sharding tests (8 virtual CPU devices)."""
import numpy as np
import pytest

import jax

from cufhe_jax import golden as G
from cufhe_jax.models import Context, decrypt_bits, encrypt_bits
from cufhe_jax.models import circuits as C
from cufhe_jax.parallel import data_mesh


@pytest.fixture(scope="module")
def ctx(tiny_key):
    _, ek = tiny_key
    return Context(ek)


def test_context_gate_roundtrip(ctx, tiny_key, rng):
    sk, _ = tiny_key
    a = encrypt_bits([0, 1, 0, 1], sk, rng)
    b = encrypt_bits([0, 0, 1, 1], sk, rng)
    out = ctx.nand(a, b)
    assert decrypt_bits(out, sk).tolist() == [1, 1, 1, 0]
    out = ctx.xor(a, b)
    assert decrypt_bits(out, sk).tolist() == [0, 1, 1, 0]
    out = ctx.mux(encrypt_bits([1, 0, 1, 0], sk, rng), a, b)
    assert decrypt_bits(out, sk).tolist() == [0, 0, 0, 1]
    assert decrypt_bits(ctx.not_(a), sk).tolist() == [1, 0, 1, 0]


def test_context_rejects_bad_input(ctx, tiny_key, rng):
    sk, _ = tiny_key
    a = encrypt_bits([1], sk, rng, level=0)
    b = encrypt_bits([1], sk, rng, level=1)
    with pytest.raises(ValueError, match="unknown gate"):
        ctx.gate("nandd", a, a)
    with pytest.raises(ValueError, match="share a level"):
        ctx.gate("nand", a, b)


def test_full_adder_circuit(ctx, tiny_key, rng):
    sk, _ = tiny_key
    # two 3-bit words per batch lane: batch of 2 additions
    av, bv = [3, 5], [6, 3]
    a = [encrypt_bits([(v >> i) & 1 for v in av], sk, rng) for i in range(3)]
    b = [encrypt_bits([(v >> i) & 1 for v in bv], sk, rng) for i in range(3)]
    cin = encrypt_bits([0, 0], sk, rng)
    s, cout = C.ripple_carry_add(ctx, a, b, cin)
    got = [sum(int(decrypt_bits(bit, sk)[lane]) << i
               for i, bit in enumerate(s))
           + (int(decrypt_bits(cout, sk)[lane]) << 3)
           for lane in range(2)]
    assert got == [9, 8]


def test_mesh_sharded_matches_unsharded(tiny_key, rng):
    sk, ek = tiny_key
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    mesh = data_mesh()
    ctx_m = Context(ek, mesh=mesh)
    ctx_s = Context(ek)
    bits0 = [i & 1 for i in range(16)]
    bits1 = [(i >> 1) & 1 for i in range(16)]
    a = encrypt_bits(bits0, sk, rng)
    b = encrypt_bits(bits1, sk, rng)
    out_m = ctx_m.nand(a, b)
    out_s = ctx_s.nand(a, b)
    assert np.array_equal(np.asarray(out_m.data), np.asarray(out_s.data))
    # result really is sharded over the mesh
    assert len(out_m.data.sharding.device_set) == 8
    assert decrypt_bits(out_m, sk).tolist() == \
        [1 - (x & y) for x, y in zip(bits0, bits1)]


def test_subtract_compare_popcount_circuits(ctx, tiny_key, rng):
    """models.circuits: two's-complement subtract, less_than, popcount."""
    from cufhe_jax.models import circuits as C
    from cufhe_jax.models.api import decrypt_bits, encrypt_bits
    sk, _ = tiny_key
    nbits, B = 3, 4
    a_vals = rng.integers(0, 8, B)
    b_vals = rng.integers(0, 8, B)
    a = [encrypt_bits((a_vals >> i) & 1, sk, rng) for i in range(nbits)]
    b = [encrypt_bits((b_vals >> i) & 1, sk, rng) for i in range(nbits)]
    diff, geq = C.ripple_carry_sub(ctx, a, b)
    got = sum(decrypt_bits(d, sk).astype(int) << i
              for i, d in enumerate(diff))
    assert np.array_equal(got, (a_vals - b_vals) % 8)
    assert np.array_equal(decrypt_bits(geq, sk), (a_vals >= b_vals))
    lt = C.less_than(ctx, a, b)
    assert np.array_equal(decrypt_bits(lt, sk), (a_vals < b_vals))
    cnt = C.popcount(ctx, a)
    got = sum(decrypt_bits(c, sk).astype(int) << i
              for i, c in enumerate(cnt))
    want = np.array([bin(v).count("1") for v in a_vals])
    assert np.array_equal(got, want)


def test_multiply_circuit(ctx, tiny_key, rng):
    """models.circuits.multiply: carry-save n x m product vs integers."""
    from cufhe_jax.models import circuits as C
    from cufhe_jax.models.api import decrypt_bits, encrypt_bits
    sk, _ = tiny_key
    B = 4
    a_vals = rng.integers(0, 8, B)        # 3-bit
    b_vals = rng.integers(0, 4, B)        # 2-bit
    a = [encrypt_bits((a_vals >> i) & 1, sk, rng) for i in range(3)]
    b = [encrypt_bits((b_vals >> i) & 1, sk, rng) for i in range(2)]
    prod = C.multiply(ctx, a, b)
    got = sum(decrypt_bits(p, sk).astype(int) << i
              for i, p in enumerate(prod))
    assert np.array_equal(got, a_vals * b_vals)


def test_gate_chain_matches_looped_gates(ctx, tiny_key, rng):
    """Context.gate_chain (one lax.scan program per chain) must be
    bit-identical to the same number of separate gate() calls."""
    import jax

    from cufhe_jax.models.api import encrypt_bits
    sk, _ = tiny_key
    bits_a = rng.integers(0, 2, 8)
    bits_b = rng.integers(0, 2, 8)
    a = encrypt_bits(bits_a, sk, rng)
    b = encrypt_bits(bits_b, sk, rng)
    cur = a
    for _ in range(4):
        cur = ctx.nand(cur, b)
    fused = ctx.gate_chain("nand", a, b, 4)
    assert np.array_equal(np.asarray(jax.device_get(cur.data)),
                          np.asarray(jax.device_get(fused.data)))


def test_gate_chain_heterogeneous(ctx, tiny_key, rng):
    """A mixed-gate chain (scan over per-step constants) must be
    bit-identical to the same sequence of separate gate() calls."""
    import jax

    from cufhe_jax.models.api import encrypt_bits
    sk, _ = tiny_key
    a = encrypt_bits(rng.integers(0, 2, 8), sk, rng)
    b = encrypt_bits(rng.integers(0, 2, 8), sk, rng)
    names = ["nand", "xor", "andyn", "orny"]
    cur = a
    for nm in names:
        cur = ctx.gate(nm, cur, b)
    fused = ctx.gate_chain(names, a, b)
    assert np.array_equal(np.asarray(jax.device_get(cur.data)),
                          np.asarray(jax.device_get(fused.data)))


def test_gate_chain_requires_depth_for_single_name(tiny_key, rng):
    from cufhe_jax.models.api import Context, encrypt_bits

    sk, ek = tiny_key
    ctx = Context(ek)
    a = encrypt_bits([1, 0], sk, rng)
    b = encrypt_bits([1, 1], sk, rng)
    with pytest.raises(ValueError, match="depth is required"):
        ctx.gate_chain("nand", a, b)
