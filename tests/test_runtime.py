"""Native C++ circuit scheduler + batched executor + stream shims.

Covers the runtime layer the reference leaves to callers: DAG building,
dead-code elimination, ASAP levelization, opcode grouping (native and the
pure-Python fallback must agree), end-to-end encrypted circuit execution vs
a plaintext oracle, and stream completion-polling semantics
(reference test_intensive.cc:21-54 pattern).
"""
import numpy as np
import pytest

from cufhe_jax import golden as G
from cufhe_jax.models import Context, Ctxt, decrypt_bits, encrypt_bits
from cufhe_jax.runtime import (CircuitBuilder, Stream, build_ripple_adder,
                               native_available, run_schedule, stream_query,
                               synchronize, trivial_ciphertext)


def test_native_library_builds():
    assert native_available(), "C++ scheduler must build in this environment"


@pytest.mark.parametrize("force_python", [False, True])
def test_schedule_levels_and_dce(force_python):
    cb = CircuitBuilder(force_python=force_python)
    a, b, c = cb.input(), cb.input(), cb.input()
    x = cb.gate("and", a, b)          # level 1
    y = cb.gate("xor", x, c)          # level 2
    dead = cb.gate("or", a, b)        # dead: not reachable from outputs
    z = cb.gate("nand", x, y)         # level 3
    cb.output(z)
    s = cb.compile()
    assert s.num_gates == 3           # `dead` eliminated
    assert [sorted(op for op, _ in lvl) for lvl in s.levels] == \
        [["and"], ["xor"], ["nand"]]
    assert s.outputs == [z]
    assert s.inputs == [a, b, c]
    del dead


def test_native_and_python_schedules_agree():
    def build(fp):
        cb, wires = build_ripple_adder(4, force_python=fp)
        return cb.compile()
    sn, sp = build(False), build(True)
    assert sn.num_wires == sp.num_wires
    assert sn.num_levels == sp.num_levels
    assert sn.outputs == sp.outputs
    for ln, lp in zip(sn.levels, sp.levels):
        assert {op: sorted(g) for op, g in ln} == \
            {op: sorted(g) for op, g in lp}


def test_same_level_gate_grouping():
    """8 independent NANDs must schedule as one level-1 group of 8."""
    cb = CircuitBuilder()
    ins = [(cb.input(), cb.input()) for _ in range(8)]
    for a, b in ins:
        cb.output(cb.gate("nand", a, b))
    s = cb.compile()
    assert s.num_levels == 1          # one gate level (inputs are level 0)
    (op, quads), = s.levels[0]
    assert op == "nand" and len(quads) == 8


def test_mux_and_const_wires(tiny_key, rng):
    sk, ek = tiny_key
    ctx = Context(ek)
    cb = CircuitBuilder()
    sel, x = cb.input(), cb.input()
    one = cb.const(1)
    # out = sel ? x : 1
    cb.output(cb.gate("mux", sel, x, one))
    s = cb.compile()
    B = 4
    sel_bits = np.array([0, 1, 0, 1])
    x_bits = np.array([0, 0, 1, 1])
    outs = run_schedule(ctx, s, [encrypt_bits(sel_bits, sk, rng),
                                 encrypt_bits(x_bits, sk, rng)])
    got = decrypt_bits(outs[0], sk)
    want = np.where(sel_bits == 1, x_bits, 1)
    assert np.array_equal(got, want)


def test_ripple_adder_end_to_end(tiny_key, rng):
    """4-bit adder over an encrypted batch vs plaintext addition."""
    sk, ek = tiny_key
    ctx = Context(ek)
    nbits, B = 4, 3
    cb, wires = build_ripple_adder(nbits)
    s = cb.compile()
    a_vals = rng.integers(0, 1 << nbits, B)
    b_vals = rng.integers(0, 1 << nbits, B)
    enc = []
    for i in range(nbits):
        enc.append(encrypt_bits((a_vals >> i) & 1, sk, rng))
    for i in range(nbits):
        enc.append(encrypt_bits((b_vals >> i) & 1, sk, rng))
    enc.append(encrypt_bits(np.zeros(B, dtype=int), sk, rng))  # cin
    outs = run_schedule(ctx, s, enc)
    got = np.zeros(B, dtype=int)
    for i, out in enumerate(outs):        # nbits sum bits + carry
        got += decrypt_bits(out, sk).astype(int) << i
    assert np.array_equal(got, a_vals + b_vals)


def test_trivial_ciphertext_decrypts_under_any_key(tiny_key):
    sk, ek = tiny_key
    p = ek.params
    ct = np.asarray(trivial_ciphertext(1, p.lvl0.dim, p.lvl0.mu, 2))
    assert G.decrypt_bit(ct[0], sk) == 1
    ct0 = np.asarray(trivial_ciphertext(0, p.lvl0.dim, p.lvl0.mu, 2))
    assert G.decrypt_bit(ct0[0], sk) == 0


def test_stream_query_and_synchronize(tiny_key, rng):
    """Completion-polling scheduler pattern (test_intensive analogue):
    chain ops on streams, poll StreamQuery, launch next the moment idle."""
    sk, ek = tiny_key
    ctx = Context(ek)
    n_streams, chain = 4, 3
    bits = rng.integers(0, 2, n_streams)
    streams = [Stream() for _ in range(n_streams)]
    cts = [encrypt_bits([b], sk, rng) for b in bits]
    depth = [0] * n_streams
    # poll-driven chaining: out = NAND(out, out) repeatedly
    while min(depth) < chain:
        for i, st in enumerate(streams):
            if depth[i] < chain and stream_query(st):
                cts[i] = ctx.nand(cts[i], cts[i])
                st.record(cts[i])
                depth[i] += 1
    synchronize(*streams)
    for i, b in enumerate(bits):
        want = int(b)
        for _ in range(chain):
            want = 1 - (want & want)
        assert decrypt_bits(cts[i], sk)[0] == want
    synchronize()  # global form runs without error


def test_streams_execute_on_their_devices(tiny_key, rng):
    """Two streams round-robin onto different devices and the gates really
    run there (reference multi-GPU stream dispatch, cufhe_gpu.cuh:152-189):
    the outputs' device buffers live on each stream's device."""
    import jax
    sk, ek = tiny_key
    devs = jax.devices()
    assert len(devs) >= 2
    ctx = Context(ek)
    st0, st1 = Stream(device=devs[0]), Stream(device=devs[1])
    a = encrypt_bits([1, 0], sk, rng)
    b = encrypt_bits([1, 1], sk, rng)
    out0 = ctx.nand(a, b, stream=st0)
    out1 = ctx.nand(a, b, stream=st1)
    assert out0.data.devices() == {devs[0]}
    assert out1.data.devices() == {devs[1]}
    # per-device key replicas were materialized lazily
    assert set(ctx._dev_keys) == {devs[0], devs[1]}
    synchronize(st0, st1)
    assert decrypt_bits(out0, sk).tolist() == [0, 1]
    assert decrypt_bits(out1, sk).tolist() == [0, 1]
    # device-resident chaining stays on the stream's device
    out2 = ctx.nand(out1, out1, stream=st1)
    assert out2.data.devices() == {devs[1]}


def test_bristol_two_bit_adder(tiny_key, rng):
    """Parse and execute a hand-written Bristol Fashion 2-bit adder
    (a + b -> 3-bit sum) against plaintext addition."""
    from cufhe_jax.runtime.bristol import compile_bristol
    # 2-bit adder: inputs a0 a1 (wires 0,1), b0 b1 (2,3); outputs s0 s1 s2
    # = wires 13,14,15 of 16.
    text = """\
9 16
2 2 2
1 3
2 1 0 2 13 XOR
2 1 0 2 5 AND
2 1 1 3 6 XOR
2 1 1 3 7 AND
2 1 6 5 14 XOR
2 1 6 5 9 AND
2 1 9 7 10 OR
1 1 10 11 EQW
1 1 11 15 EQW
"""
    sched, meta = compile_bristol(text)
    assert meta["input_widths"] == [2, 2]
    sk, ek = tiny_key
    from cufhe_jax.models import Context, decrypt_bits, encrypt_bits
    ctx = Context(ek)
    B = 4
    a_vals = rng.integers(0, 4, B)
    b_vals = rng.integers(0, 4, B)
    enc = [encrypt_bits((a_vals >> i) & 1, sk, rng) for i in range(2)]
    enc += [encrypt_bits((b_vals >> i) & 1, sk, rng) for i in range(2)]
    outs = run_schedule(ctx, sched, enc)
    got = sum(decrypt_bits(o, sk).astype(int) << i
              for i, o in enumerate(outs))
    assert np.array_equal(got, a_vals + b_vals)


def test_bristol_const_inv_mux(tiny_key, rng):
    """EQ constants, INV, and the Bristol MUX convention."""
    from cufhe_jax.runtime.bristol import compile_bristol
    # inputs: s (wire 0), x (wire 1); wires: 2=const1, 3=INV x,
    # out 4 = MUX(s, const1, INV x) = s ? INV x : 1
    text = """\
3 5
2 1 1
1 1
1 1 1 2 EQ
1 1 1 3 INV
3 1 0 2 3 4 MUX
"""
    sched, meta = compile_bristol(text)
    sk, ek = tiny_key
    from cufhe_jax.models import Context, decrypt_bits, encrypt_bits
    ctx = Context(ek)
    s_bits = np.array([0, 1, 0, 1])
    x_bits = np.array([0, 0, 1, 1])
    outs = run_schedule(ctx, sched, [encrypt_bits(s_bits, sk, rng),
                                     encrypt_bits(x_bits, sk, rng)])
    got = decrypt_bits(outs[0], sk)
    want = np.where(s_bits == 1, 1 - x_bits, 1)
    assert np.array_equal(got, want)


def test_bristol_rejects_cyclic(tiny_key):
    from cufhe_jax.runtime.bristol import compile_bristol
    text = """\
2 4
1 2
1 1
2 1 0 3 2 XOR
2 1 0 2 3 XOR
"""
    with pytest.raises(ValueError, match="topologically"):
        compile_bristol(text)


def test_precompile_and_chunked_execution(tiny_key, rng, monkeypatch):
    """Tiny CUFHE_EXEC_CHUNK forces multi-chunk levels + ladder tails; the
    precompiled + chunked run must match the plaintext adder exactly, and
    precompile_schedule must cover every shape (no new compiles at run
    time is a perf property checked on hardware; here we check identity)."""
    from cufhe_jax.runtime import build_ripple_adder
    from cufhe_jax.runtime.executor import precompile_schedule

    monkeypatch.setenv("CUFHE_EXEC_CHUNK", "2")
    monkeypatch.setenv("CUFHE_FUSE_MAX", "0")   # pin the chunked path
    sk, ek = tiny_key
    ctx = Context(ek)
    nbits, B = 4, 3
    cb, _ = build_ripple_adder(nbits)
    s = cb.compile()
    n_progs = precompile_schedule(ctx, s, B)
    assert n_progs >= 1
    a_vals = rng.integers(0, 1 << nbits, B)
    b_vals = rng.integers(0, 1 << nbits, B)
    enc = [encrypt_bits((a_vals >> i) & 1, sk, rng) for i in range(nbits)]
    enc += [encrypt_bits((b_vals >> i) & 1, sk, rng) for i in range(nbits)]
    enc.append(encrypt_bits(np.zeros(B, dtype=int), sk, rng))
    outs = run_schedule(ctx, s, enc)
    got = np.zeros(B, dtype=int)
    for i, out in enumerate(outs):
        got += decrypt_bits(out, sk).astype(int) << i
    assert np.array_equal(got, a_vals + b_vals)


def test_run_schedule_with_mesh(tiny_key, rng):
    """The executor's mesh fallback path (gather/gate_rows/scatter with the
    batch sharded over all devices) — kept alongside the donated
    single-device fast path, so it needs its own end-to-end coverage."""
    import jax
    from cufhe_jax.parallel.mesh import data_mesh
    from cufhe_jax.runtime import build_ripple_adder

    sk, ek = tiny_key
    mesh = data_mesh()
    ctx = Context(ek, mesh=mesh)
    nbits, B = 4, len(jax.devices()) * 2
    cb, _ = build_ripple_adder(nbits)
    s = cb.compile()
    a_vals = rng.integers(0, 1 << nbits, B)
    b_vals = rng.integers(0, 1 << nbits, B)
    enc = [encrypt_bits((a_vals >> i) & 1, sk, rng) for i in range(nbits)]
    enc += [encrypt_bits((b_vals >> i) & 1, sk, rng) for i in range(nbits)]
    enc.append(encrypt_bits(np.zeros(B, dtype=int), sk, rng))
    outs = run_schedule(ctx, s, enc)
    got = np.zeros(B, dtype=int)
    for i, out in enumerate(outs):
        got += decrypt_bits(out, sk).astype(int) << i
    assert np.array_equal(got, a_vals + b_vals)


# ---------------------------------------------------------------------------
# NOT/COPY absorption optimizer
# ---------------------------------------------------------------------------
def test_neg_variant_table_is_boolean_correct():
    """Every negated-input variant must match its truth table (the same
    table the native kNegVar mirrors)."""
    import itertools

    from cufhe_jax.golden import PLAIN_GATES
    from cufhe_jax.runtime.graph import NEG_VARIANT
    for op, (v0, v1) in NEG_VARIANT.items():
        for a, b in itertools.product((0, 1), repeat=2):
            assert PLAIN_GATES[op](1 - a, b) == PLAIN_GATES[v0](a, b)
            assert PLAIN_GATES[op](a, 1 - b) == PLAIN_GATES[v1](a, b)


@pytest.mark.parametrize("force_python", [False, True])
def test_optimizer_absorbs_not_copy(force_python):
    """not->variant absorption, copy aliasing, double-not cancellation,
    mux selector swap, canonical-NOT dedup — native and Python agree."""
    cb = CircuitBuilder(force_python=force_python)
    a, b, c = cb.input(), cb.input(), cb.input()
    na = cb.gate("not", a)
    z = cb.gate("nand", na, b)                 # -> oryn(a, b)
    cp = cb.gate("copy", z)
    nn = cb.gate("not", cb.gate("not", b))     # -> b
    y = cb.gate("xor", cp, nn)                 # -> xor(z, b)
    nc = cb.gate("not", c)
    m = cb.gate("mux", nc, y, z)               # -> mux(c, z, y)
    n1 = cb.gate("not", y)
    n2 = cb.gate("not", cb.gate("copy", y))    # dedups with n1
    m2 = cb.gate("mux", c, n1, n2)             # data operands keep ONE not
    cb.output(m)
    cb.output(m2)
    s = cb.compile()
    quads = {q[0]: (op, q[1:]) for lvl in s.levels
             for op, qs in lvl for q in qs}
    assert quads[z] == ("oryn", (a, b, -1))
    assert quads[y] == ("xor", (z, b, -1))
    assert quads[m] == ("mux", (c, z, y))
    assert na not in quads and cp not in quads and nn not in quads
    nots = [w for w, (op, _) in quads.items() if op == "not"]
    assert len(nots) == 1                      # n1/n2 dedup to one
    assert quads[m2] == ("mux", (c, nots[0], nots[0]))


def test_optimizer_native_and_python_agree():
    def build(fp, opt):
        cb = CircuitBuilder(force_python=fp)
        ins = [cb.input() for _ in range(6)]
        rng = np.random.default_rng(3)
        wires = list(ins)
        for i in range(60):
            k = rng.integers(0, 5)
            if k == 0:
                wires.append(cb.gate("not", int(rng.choice(wires))))
            elif k == 1:
                wires.append(cb.gate("copy", int(rng.choice(wires))))
            elif k == 2:
                wires.append(cb.gate("mux", int(rng.choice(wires)),
                                     int(rng.choice(wires)),
                                     int(rng.choice(wires))))
            else:
                from cufhe_jax.runtime.graph import OPS_2IN
                op = OPS_2IN[int(rng.integers(0, len(OPS_2IN)))]
                wires.append(cb.gate(op, int(rng.choice(wires)),
                                     int(rng.choice(wires))))
        for w in wires[-4:]:
            cb.output(w)
        return cb.compile(optimize=opt)
    for opt in (False, True):
        sn, sp = build(False, opt), build(True, opt)
        assert sn.outputs == sp.outputs
        assert sn.num_levels == sp.num_levels
        for ln, lp in zip(sn.levels, sp.levels):
            assert {op: sorted(g) for op, g in ln} == \
                {op: sorted(g) for op, g in lp}


def test_optimizer_bit_exact_encrypted(tiny_key, rng):
    """For the +-1-coefficient gates, mux, and copy, optimized and
    unoptimized schedules must produce BIT-identical output ciphertexts:
    the variant gates' linear constants apply exactly the sign the
    absorbed NOT would have (graph.py NEG_VARIANT)."""
    from cufhe_jax.runtime.executor import simulate_schedule

    def build():
        cb = CircuitBuilder()
        a, b, c = cb.input(), cb.input(), cb.input()
        na = cb.gate("not", a)
        g1 = cb.gate("and", na, b)                  # -> andny(a, b)
        g2 = cb.gate("oryn", cb.gate("not", b), c)  # -> nand(b, c)
        g3 = cb.gate("mux", cb.gate("not", c), g1, g2)  # -> mux(c, g2, g1)
        g4 = cb.gate("nor", g3, cb.gate("copy", g1))
        cb.output(g4)
        cb.output(cb.gate("not", g4))               # output-level NOT kept
        return cb

    sk, ek = tiny_key
    ctx = Context(ek)
    B = 4
    bits = [rng.integers(0, 2, B) for _ in range(3)]
    enc = [encrypt_bits(bt, sk, rng) for bt in bits]
    s_raw = build().compile(optimize=False)
    s_opt = build().compile(optimize=True)
    assert s_opt.num_gates < s_raw.num_gates
    # plaintext simulation agrees between the two schedules
    for o_raw, o_opt in zip(simulate_schedule(s_raw, bits),
                            simulate_schedule(s_opt, bits)):
        assert np.array_equal(o_raw, o_opt)
    outs_raw = run_schedule(ctx, s_raw, enc)
    outs_opt = run_schedule(ctx, s_opt, enc)
    for o_raw, o_opt in zip(outs_raw, outs_opt):
        assert np.array_equal(np.asarray(o_raw.data),
                              np.asarray(o_opt.data))


def test_optimizer_xor_absorption_decodes_identically(tiny_key, rng):
    """xor/xnor absorption is decode-equivalent (not bit-exact: their +-2
    coefficients leave a 4*noise pre-rotation difference) — all four input
    combinations must decrypt to the same bits through a NOT->XOR chain."""
    def build():
        cb = CircuitBuilder()
        a, b = cb.input(), cb.input()
        g = cb.gate("xor", cb.gate("not", a), b)    # -> xnor(a, b)
        cb.output(cb.gate("xnor", g, cb.gate("not", b)))  # -> xor(g, b)
        return cb

    sk, ek = tiny_key
    ctx = Context(ek)
    a_bits = np.array([0, 0, 1, 1])
    b_bits = np.array([0, 1, 0, 1])
    enc = [encrypt_bits(a_bits, sk, rng), encrypt_bits(b_bits, sk, rng)]
    s_opt = build().compile(optimize=True)
    ops = [op for lvl in s_opt.levels for op, _ in lvl]
    assert "not" not in ops and "xor" in ops and "xnor" in ops
    want = 1 - (((1 - a_bits) ^ b_bits) ^ (1 - b_bits))
    got = decrypt_bits(run_schedule(ctx, s_opt, enc)[0], sk)
    assert np.array_equal(got, want)


def test_fused_small_circuit_matches_stepped(tiny_key, rng, monkeypatch):
    """Whole-schedule fusion (default for small circuits) must match the
    chunked step path bit-for-bit — same gates, same order, one program."""
    import jax

    from cufhe_jax.runtime import build_ripple_adder

    sk, ek = tiny_key
    nbits, B = 4, 3
    cb, _ = build_ripple_adder(nbits)
    s = cb.compile()
    a_vals = rng.integers(0, 1 << nbits, B)
    b_vals = rng.integers(0, 1 << nbits, B)
    enc = [encrypt_bits((a_vals >> i) & 1, sk, rng) for i in range(nbits)]
    enc += [encrypt_bits((b_vals >> i) & 1, sk, rng) for i in range(nbits)]
    enc.append(encrypt_bits(np.zeros(B, dtype=int), sk, rng))

    monkeypatch.setenv("CUFHE_FUSE_MAX", "512")
    outs_fused = run_schedule(Context(ek), s, enc)
    monkeypatch.setenv("CUFHE_FUSE_MAX", "0")
    outs_step = run_schedule(Context(ek), s, enc)
    for of, os_ in zip(outs_fused, outs_step):
        assert np.array_equal(np.asarray(jax.device_get(of.data)),
                              np.asarray(jax.device_get(os_.data)))
    got = np.zeros(B, dtype=int)
    for i, out in enumerate(outs_fused):
        got += decrypt_bits(out, sk).astype(int) << i
    assert np.array_equal(got, a_vals + b_vals)


def test_run_schedule_loop_with_consts(tiny_key, rng):
    """Scanned feedback loop over a circuit with const wires: the consts
    are re-presented every iteration, and the result is bit-identical to
    the per-cycle run_schedule loop."""
    from cufhe_jax.runtime import CircuitBuilder, run_schedule_loop

    sk, ek = tiny_key
    ctx = Context(ek)
    cb = CircuitBuilder()
    sel, x = cb.input(), cb.input()
    one = cb.const(1)
    # x' = sel ? (x nand 1) : 1  — feedback on x, sel held
    y = cb.gate("nand", x, one)
    cb.output(cb.gate("mux", sel, y, one))
    s = cb.compile()
    B = 4
    sel_bits = np.array([0, 1, 0, 1])
    x_bits = np.array([0, 0, 1, 1])
    ins = [encrypt_bits(sel_bits, sk, rng), encrypt_bits(x_bits, sk, rng)]
    got = run_schedule_loop(ctx, s, ins, cycles=3, feedback=[(0, 1)])
    # per-cycle reference
    state = ins[1]
    for _ in range(3):
        state = run_schedule(ctx, s, [ins[0], state])[0]
    assert np.array_equal(np.asarray(got[0].data), np.asarray(state.data))
    want = x_bits.copy()
    for _ in range(3):
        want = np.where(sel_bits == 1, 1 - (want & 1), 1)
    assert np.array_equal(decrypt_bits(got[0], sk), want)


def test_run_schedule_loop_segmented_bitexact(tiny_key, rng):
    """Host-segmented scanned loop (feedback planes carried between
    dispatches) is bit-identical to the single-scan program — the split
    long multi-cycle runs need where the environment bounds per-dispatch
    duration (CUFHE_LOOP_SEG; the bench rig kills executions past ~65 s)."""
    from cufhe_jax.runtime import CircuitBuilder, run_schedule_loop

    sk, ek = tiny_key
    ctx = Context(ek)
    cb = CircuitBuilder()
    sel, x = cb.input(), cb.input()
    one = cb.const(1)
    y = cb.gate("nand", x, one)
    cb.output(cb.gate("mux", sel, y, one))
    s = cb.compile()
    sel_bits = np.array([0, 1, 0, 1])
    x_bits = np.array([0, 0, 1, 1])
    ins = [encrypt_bits(sel_bits, sk, rng), encrypt_bits(x_bits, sk, rng)]
    whole = run_schedule_loop(ctx, s, ins, cycles=5, feedback=[(0, 1)])
    segd = run_schedule_loop(ctx, s, ins, cycles=5, feedback=[(0, 1)],
                             segment=2)   # uneven split: 2 + 2 + 1
    assert np.array_equal(np.asarray(whole[0].data), np.asarray(segd[0].data))
