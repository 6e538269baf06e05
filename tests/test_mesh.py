"""Multi-device coverage of the production ("auto") path.

The reference's multi-GPU gate test (test_gate_gpu_multi.cc:36-85) runs the
real bootstrap kernel on every device. Here the equivalent property is that
the gate program partitions over the data axis of an 8-device mesh via
shard_map — bit-identically to the unsharded program, with zero
inter-device collectives in the compiled HLO (gate evaluation is
embarrassingly parallel; keys are replicated).
"""
import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from cufhe_jax import golden as G
from cufhe_jax import params as P
from cufhe_jax.models.api import Context, Ctxt, decrypt_bits, encrypt_bits
from cufhe_jax.ops import bootstrap as B
from cufhe_jax.parallel.mesh import data_mesh, data_parallel

COLLECTIVES = ("all-reduce", "all-gather", "all-to-all", "collective-permute",
               "reduce-scatter")


@pytest.fixture(scope="module")
def n128_key():
    sk = G.keygen(P.TINY_N128, seed=11)
    ek = G.make_eval_key(sk, seed=12)
    return sk, ek


def test_pallas_gate_sharded_matches_unsharded(n128_key, rng):
    """TINY_N128 (N=128) on the resolved path: this runs the production
    gate program per-shard on all 8 devices."""
    sk, ek = n128_key
    assert B.resolve_backend("auto", ek.params) in B.BACKENDS
    assert len(jax.devices()) == 8
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
    assert len(out_m.data.sharding.device_set) == 8
    assert decrypt_bits(out_m, sk).tolist() == \
        [1 - (x & y) for x, y in zip(bits0, bits1)]


def test_pallas_gate_sharded_no_collectives(n128_key, rng):
    """The sharded gate program must contain zero collective ops — the
    ≥80%-scaling story rests on gate eval being communication-free
    (SURVEY.md §2 parallelism table)."""
    sk, ek = n128_key
    mesh = data_mesh()
    ctx = Context(ek, mesh=mesh)
    a = encrypt_bits([1] * 16, sk, rng)
    b = encrypt_bits([1] * 16, sk, rng)
    out = ctx.nand(a, b)  # populates the program cache
    prog = ctx._cache[("gate", 0)]
    c3 = B.encode_gate_consts(G.GATE_CONSTANTS["nand"], ek.params.lvl0.mu)
    hlo = prog.lower(c3, ctx._shard(a.data), ctx._shard(b.data),
                     ctx.keys).compile().as_text()
    for coll in COLLECTIVES:
        assert coll not in hlo, f"unexpected collective {coll} in gate HLO"
    assert len(out.data.sharding.device_set) == 8


def test_pallas_k2_sharded_matches_unsharded(rng):
    """CONCRETE-style k=2 shape through the sharded resolved path."""
    sk = G.keygen(P.TINY_K2_N128, seed=13)
    ek = G.make_eval_key(sk, seed=14)
    assert B.resolve_backend("auto", ek.params) in B.BACKENDS
    mesh = data_mesh()
    ctx_m = Context(ek, mesh=mesh)
    ctx_s = Context(ek)
    bits0 = [1, 0, 1, 1, 0, 0, 1, 0]
    bits1 = [1, 1, 0, 1, 0, 1, 0, 0]
    a = encrypt_bits(bits0, sk, rng)
    b = encrypt_bits(bits1, sk, rng)
    out_m = ctx_m.xor(a, b)
    out_s = ctx_s.xor(a, b)
    assert np.array_equal(np.asarray(out_m.data), np.asarray(out_s.data))
    assert decrypt_bits(out_m, sk).tolist() == \
        [x ^ y for x, y in zip(bits0, bits1)]


def test_data_parallel_preserves_output_sharding(n128_key, rng):
    """Direct shard_map wrap of gate_lvl0 (what dryrun_multichip runs)."""
    sk, ek = n128_key
    p = ek.params
    mesh = data_mesh()
    from cufhe_jax.ops import keys as K
    keys = jax.device_put(
        K.prepare_keys(ek, backends=(B.resolve_backend("auto", p),)),
        NamedSharding(mesh, PartitionSpec()))
    shard = NamedSharding(mesh, PartitionSpec("data"))
    a = jax.device_put(encrypt_bits([1] * 8, sk, rng).data, shard)
    b = jax.device_put(encrypt_bits([0, 1] * 4, sk, rng).data, shard)

    fn = lambda x, y, k: B.gate_lvl0(G.GATE_CONSTANTS["nand"], x, y, k, p)
    out = jax.jit(data_parallel(fn, mesh, (0, 1)))(a, b, keys)
    out.block_until_ready()
    assert out.sharding.spec == PartitionSpec("data")
    ref = np.stack([G.gate_lvl0("nand", np.asarray(a)[i], np.asarray(b)[i],
                                ek) for i in range(8)])
    assert np.array_equal(np.asarray(out), ref)


def test_pbs_per_batch_tv_sharded_matches_unsharded(n128_key, rng):
    """A per-batch test vector ([B, N]) must shard WITH the ciphertext
    batch under a mesh Context; sharded == unsharded bit-exact."""
    sk, ek = n128_key
    p = sk.params
    B = 16
    bits = rng.integers(0, 2, B)
    cts = encrypt_bits(bits, sk, rng)
    tvs = rng.integers(0, 1 << 32, (B, p.lvl1.n),
                       dtype=np.uint64).astype(np.uint32)
    plain = Context(ek).pbs_tlwe2trlwe(cts, tvs)
    mesh = Context(ek, mesh=data_mesh()).pbs_tlwe2trlwe(cts, tvs)
    assert np.array_equal(np.asarray(jax.device_get(plain.data)),
                          np.asarray(jax.device_get(mesh.data)))


def test_gate_chain_sharded_matches_unsharded(n128_key, rng):
    """Fused dependent chains (lax.scan over the bootstrap) under a mesh
    Context: sharded == unsharded bit-exact."""
    sk, ek = n128_key
    B = 16
    bits0 = rng.integers(0, 2, B)
    bits1 = rng.integers(0, 2, B)
    a = encrypt_bits(bits0, sk, rng)
    b = encrypt_bits(bits1, sk, rng)
    names = ["nand", "xor", "or", "and"]
    plain = Context(ek).gate_chain(names, a, b)
    mesh = Context(ek, mesh=data_mesh()).gate_chain(names, a, b)
    assert np.array_equal(np.asarray(jax.device_get(plain.data)),
                          np.asarray(jax.device_get(mesh.data)))


def test_integer_add_sharded_matches_unsharded(n128_key, rng):
    """The encrypted-integer ripple adder (scanned pbs_many) under a mesh
    Context: word batch sharded over the data axis, sharded == unsharded
    bit-exact, and the decrypted sums correct."""
    from cufhe_jax.models import (IntContext, decrypt_uint, encrypt_uint)

    sk, ek = n128_key
    B = 16
    mod = 1 << 4
    xs = [int(v) for v in rng.integers(0, mod, B)]
    ys = [int(v) for v in rng.integers(0, mod, B)]
    x = encrypt_uint(xs, 4, sk, rng=rng)
    y = encrypt_uint(ys, 4, sk, rng=rng)
    plain = IntContext(Context(ek)).add(x, y)
    ictx_m = IntContext(Context(ek, mesh=data_mesh()))
    mesh = ictx_m.add(x, y)
    assert np.array_equal(np.asarray(jax.device_get(plain.digits)),
                          np.asarray(jax.device_get(mesh.digits)))
    assert len(mesh.digits.sharding.device_set) == 8
    assert decrypt_uint(mesh, sk) == [(a + b) % mod for a, b in zip(xs, ys)]


def test_run_schedule_loop_sharded_matches_unsharded(rng):
    """The scanned feedback loop (run_schedule_loop) under a mesh must be
    bit-identical to the unsharded loop — VERDICT r4 #6: the sequential-
    machine latency path must not refuse multi-chip Contexts."""
    from cufhe_jax.runtime import CircuitBuilder, run_schedule_loop

    sk = G.keygen(P.TINY, seed=31)
    ek = G.make_eval_key(sk, seed=32)
    mesh = data_mesh()
    ctx_m = Context(ek, mesh=mesh)
    ctx_s = Context(ek)
    cb = CircuitBuilder()
    sel, x = cb.input(), cb.input()
    one = cb.const(1)
    y = cb.gate("nand", x, one)
    cb.output(cb.gate("mux", sel, y, one))
    s = cb.compile()
    B_ = 16
    sel_bits = np.array([i & 1 for i in range(B_)])
    x_bits = np.array([(i >> 1) & 1 for i in range(B_)])
    ins = [encrypt_bits(sel_bits, sk, np.random.default_rng(33)),
           encrypt_bits(x_bits, sk, np.random.default_rng(34))]
    got_m = run_schedule_loop(ctx_m, s, ins, cycles=3, feedback=[(0, 1)])
    got_s = run_schedule_loop(ctx_s, s, ins, cycles=3, feedback=[(0, 1)])
    assert np.array_equal(np.asarray(got_m[0].data),
                          np.asarray(got_s[0].data))
    assert len(got_m[0].data.sharding.device_set) == 8
    want = x_bits.copy()
    for _ in range(3):
        want = np.where(sel_bits == 1, 1 - (want & 1), 1)
    assert np.array_equal(decrypt_bits(got_m[0], sk), want)


def test_run_schedule_loop_mesh_batch_divisibility(rng):
    from cufhe_jax.runtime import CircuitBuilder, run_schedule_loop

    sk = G.keygen(P.TINY, seed=31)
    ek = G.make_eval_key(sk, seed=32)
    ctx = Context(ek, mesh=data_mesh())
    cb = CircuitBuilder()
    a, b = cb.input(), cb.input()
    cb.output(cb.gate("nand", a, b))
    s = cb.compile()
    ins = [encrypt_bits([1] * 6, sk, rng), encrypt_bits([0] * 6, sk, rng)]
    with pytest.raises(ValueError, match="divisible"):
        run_schedule_loop(ctx, s, ins, cycles=2, feedback=[(0, 0)])
