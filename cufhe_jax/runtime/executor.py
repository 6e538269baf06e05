"""Schedule executor: runs a compiled circuit level-by-level on a Context.

Each (level, opcode) group becomes ONE batched gate program over
[n_gates * B] ciphertexts: wires are gathered from a device-resident register
file, evaluated in a single fused XLA call, and scattered back. This realizes
on the batch axis the concurrency the reference gets from one-CUDA-block-per-
gate across streams (reference cufhe_gpu.cuh:152-189), with the level
schedule guaranteeing dependence-safety (the reference's StreamQuery polling
loop, test_intensive.cc:21-54, done statically by the native scheduler).
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..models.api import Context, Ctxt
from .graph import Schedule

U32 = jnp.uint32


def trivial_ciphertext(value: int, dim: int, mu: int, batch: int) -> jnp.ndarray:
    """Noiseless public ciphertext of a constant bit: a = 0, b = ±mu.
    (TFHE 'trivial sample'; decrypts to `value` under any key.)"""
    b = np.uint32(mu if value else (-mu) % (1 << 32))
    ct = np.zeros((batch, dim + 1), dtype=np.uint32)
    ct[:, dim] = b
    return jnp.asarray(ct)


def _bucket(n: int) -> int:
    """Pad a level's fused gate count to a shape bucket: exact for tiny
    levels, multiples of 64 up to 1024, powers of two beyond — bounds the
    number of distinct compiled programs at <=10% padded bootstrap waste
    for AES-scale netlists."""
    if n <= 16:
        return n
    if n <= 1024:
        return -(-n // 64) * 64
    return 1 << (n - 1).bit_length()


def allocate_slots(sched: Schedule) -> Dict[int, int]:
    """Liveness-based register allocation: wire -> physical slot.

    The dense [num_wires, B, width] register file does not scale (a Bristol
    AES-128 netlist is ~36k wires; at B=1024 that is ~90 GB). The scheduler
    already levelizes, so a wire's slot can be recycled once its last read
    has executed — but NOT within that same level: the executor applies
    each fused group program in-place (donated register file), so slots
    freed by level L's reads only become allocatable at L+1 (see the
    comment in the allocation loop below). Returns the wire->slot map; the
    register file needs max(slot)+1 = peak-liveness slots instead of
    num_wires.
    """
    last_read: Dict[int, int] = {}
    for lvl, groups in enumerate(sched.levels, start=1):
        for _, quads in groups:
            for q in quads:
                for w in q[1:]:
                    if w >= 0:
                        last_read[w] = lvl
    for w in sched.outputs:
        last_read[w] = len(sched.levels) + 1   # outputs live to the end

    expire: Dict[int, List[int]] = {}
    for w, lvl in last_read.items():
        expire.setdefault(lvl, []).append(w)

    slot: Dict[int, int] = {}
    free: List[int] = []
    hi = 0

    def alloc(w: int) -> None:
        nonlocal hi
        if w in slot:
            return
        if free:
            slot[w] = free.pop()
        else:
            slot[w] = hi
            hi += 1

    for w in sched.inputs:
        alloc(w)
    for w in sched.consts:
        alloc(w)
    for lvl, groups in enumerate(sched.levels, start=1):
        # A level's outputs may NOT reuse slots freed by that same level's
        # operand reads: the executor applies each fused group program
        # in-place (donated register file) as soon as it is built, so a
        # later group in the level would read a slot an earlier group
        # already overwrote. Slots freed at level L become available at
        # L+1 (costs a few % more peak slots; measured 784 -> 1144 on AES).
        for _, quads in groups:
            for q in quads:
                alloc(q[0])
        for w in expire.get(lvl, ()):
            if w in slot:              # defined earlier => slot assigned
                free.append(slot[w])
    return slot


def simulate_schedule(sched: Schedule,
                      inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Plaintext (cleartext-bit) execution of a compiled circuit — the
    oracle for encrypted runs (the reference's plain.h truth-table model,
    test/plain.h:10-69, applied to whole netlists). inputs[i] is a bit
    array feeding sched.inputs[i]; arrays broadcast together (batch)."""
    from ..golden import PLAIN_GATES

    vals: Dict[int, np.ndarray] = {}
    for w, bits in zip(sched.inputs, inputs):
        vals[w] = np.asarray(bits).astype(np.int64)
    for w, v in sched.consts.items():
        vals[w] = np.int64(v)
    for groups in sched.levels:
        for opname, quads in groups:
            if opname in ("mux", "nmux"):  # PLAIN_GATES mux is scalar-only
                for q in quads:
                    sel = np.where(vals[q[1]] == 1, vals[q[2]], vals[q[3]])
                    vals[q[0]] = (1 - sel) if opname == "nmux" else sel
                continue
            fn = PLAIN_GATES[opname]
            for q in quads:
                args = [vals[a] for a in q[1:] if a >= 0]
                vals[q[0]] = fn(*args)
    return [vals[w] for w in sched.outputs]


def _exec_chunk(batch: int) -> int:
    """Max fused two-input gates per device call. Full chunks all share ONE
    compiled shape; only each level's tail takes a bucket — this bounds the
    number of distinct compiled programs for a whole netlist to a handful
    (each in-run compile costs seconds). ~16k bootstraps per call amortizes
    dispatch."""
    env = os.environ.get("CUFHE_EXEC_CHUNK", "")
    if env:
        return int(env)
    return min(1024, max(64, (16384 // batch) // 64 * 64))


def _step_fns(ctx: Context, lvl: int):
    """Cached donated-register-file level-step programs for (ctx, level).

    Each step takes the whole register file [S, B, width], gathers its
    operand rows, runs the fused gate program, and scatters outputs back —
    ONE XLA program per shape with `donate_argnums=0`, so the scatter
    aliases the register file in place instead of re-materializing it
    (round-2 executor copied the full file per level group)."""
    key = ("exec_steps", lvl)
    if key in ctx._cache:
        return ctx._cache[key]
    from ..ops import bootstrap as B
    p, bk = ctx.params, ctx.backend
    gate_fn = B.gate_lvl0 if lvl == 0 else B.gate_lvl1
    mux_fn = B.mux_lvl0 if lvl == 0 else B.mux_lvl1

    def two_input(regs, ina, inb, outs, c3, keys):
        S, bsz, width = regs.shape
        gp = ina.shape[0]
        ga = regs[ina].reshape(gp * bsz, width)
        gb = regs[inb].reshape(gp * bsz, width)
        c = jnp.repeat(c3, bsz, axis=0)
        res = gate_fn(c, ga, gb, keys=keys, params=p, backend=bk)
        return regs.at[outs].set(res.reshape(gp, bsz, width))

    def mux(regs, ic, i1, i0, outs, neg, keys):
        S, bsz, width = regs.shape
        gp = ic.shape[0]
        g = lambda x: regs[x].reshape(gp * bsz, width)
        res = mux_fn(g(ic), g(i1), g(i0), keys, p,
                     negate=bool(neg), backend=bk)
        return regs.at[outs].set(res.reshape(gp, bsz, width))

    def linear(regs, idx, outs, neg):
        vals = regs[idx]
        if neg:
            vals = jnp.negative(vals)
        return regs.at[outs].set(vals)

    fns = {
        "two": jax.jit(two_input, donate_argnums=0),
        "mux": jax.jit(mux, donate_argnums=0, static_argnums=5),
        "lin": jax.jit(linear, donate_argnums=0, static_argnums=3),
    }
    ctx._cache[key] = fns
    return fns


def _op_cols(opname: str) -> int:
    return 4 if opname in ("mux", "nmux") else 2


def _tail_ladder(tails: List[int], k: int) -> List[int]:
    """Optimal K-size bucket ladder for a schedule's level tails, by DP:
    choose <=k cut sizes (from the distinct tail sizes) such that rounding
    every tail UP to the next cut minimizes total padded gates. Bounds the
    number of distinct compiled tail shapes at k while beating any fixed
    ladder (measured: AES 5.3% / SHA-256 11.4% waste at k=8, vs 17% / 115%
    with plain multiples-of-64)."""
    vals = sorted(set(tails))
    m = len(vals)
    if m <= k:
        return vals
    cnt = {v: 0 for v in vals}
    for t in tails:
        cnt[t] += 1
    pref_n = [0]
    pref_s = [0]
    for v in vals:
        pref_n.append(pref_n[-1] + cnt[v])
        pref_s.append(pref_s[-1] + cnt[v] * v)

    def cost(i: int, j: int) -> int:   # vals[i..j] rounded up to vals[j]
        return ((pref_n[j + 1] - pref_n[i]) * vals[j]
                - (pref_s[j + 1] - pref_s[i]))

    INF = float("inf")
    dp = [[INF] * (k + 1) for _ in range(m + 1)]
    back = [[0] * (k + 1) for _ in range(m + 1)]
    dp[0][0] = 0
    for j in range(1, m + 1):
        for kk in range(1, k + 1):
            for i in range(j):
                if dp[i][kk - 1] == INF:
                    continue
                c = dp[i][kk - 1] + cost(i, j - 1)
                if c < dp[j][kk]:
                    dp[j][kk] = c
                    back[j][kk] = i
    kk = min(range(1, k + 1), key=lambda x: dp[m][x])
    cuts = []
    j = m
    while kk:
        cuts.append(vals[j - 1])
        j = back[j][kk]
        kk -= 1
    return sorted(cuts)


def _plan_level(groups, slot: Dict[int, int], chunk: int, mu: int,
                ladder: List[int]):
    """Host-side chunk plan for one level: a list of
    (kind, index-arrays..., payload) step descriptors. Fused two-input
    chunks are `chunk`-sized; tails round up to the schedule's DP-optimal
    `ladder`, padding with duplicates of quad 0 (same slot, same recomputed
    value, so the duplicate scatter is benign)."""
    from ..golden import GATE_CONSTANTS
    from ..ops.bootstrap import encode_gate_consts_rows
    two_input = {n for n in GATE_CONSTANTS
                 if n not in ("not", "copy", "mux", "nmux")}
    plan = []
    fused_quads: List[tuple] = []
    fused_names: List[str] = []
    for opname, quads in groups:
        if opname in two_input:
            fused_quads.extend(quads)
            fused_names.extend([opname] * len(quads))
            continue
        # pad not/copy/mux groups to power-of-two sizes (min 8) with
        # duplicates of quad 0 — same slot, same value, benign — so a
        # whole netlist's linear/mux groups share a handful of shapes
        g = len(quads)
        gp = max(8, 1 << (g - 1).bit_length())
        quads = list(quads) + [quads[0]] * (gp - g)
        cols = [np.asarray([slot[q[j]] for q in quads], dtype=np.int32)
                for j in range(_op_cols(opname))]
        if opname in ("not", "copy"):
            plan.append(("lin", cols[1], cols[0], opname == "not"))
        else:  # mux / nmux
            plan.append(("mux", cols[1], cols[2], cols[3], cols[0],
                         opname == "nmux"))
    pos = 0
    n = len(fused_quads)
    while pos < n:
        take = chunk if n - pos >= chunk else n - pos
        # tails round up to the schedule's DP-optimal bucket ladder
        gp = take if take == chunk else min(s for s in ladder if s >= take)
        quads_p = fused_quads[pos:pos + take] + \
            [fused_quads[pos]] * (gp - take)
        names_p = fused_names[pos:pos + take] + \
            [fused_names[pos]] * (gp - take)
        ina = np.asarray([slot[q[1]] for q in quads_p], dtype=np.int32)
        inb = np.asarray([slot[q[2]] for q in quads_p], dtype=np.int32)
        outs = np.asarray([slot[q[0]] for q in quads_p], dtype=np.int32)
        c3 = encode_gate_consts_rows(names_p, mu)
        plan.append(("two", ina, inb, outs, c3))
        pos += take
    return plan


def _plan_schedule(sched: Schedule, slot: Dict[int, int], chunk: int,
                   mu: int) -> List[list]:
    from ..golden import GATE_CONSTANTS
    two_input = {n for n in GATE_CONSTANTS
                 if n not in ("not", "copy", "mux", "nmux")}
    tails = []
    for groups in sched.levels:
        g = sum(len(q) for op, q in groups if op in two_input) % chunk
        if g:
            tails.append(g)
    k = int(os.environ.get("CUFHE_EXEC_SHAPES", "8"))
    ladder = _tail_ladder(tails, k) if tails else [chunk]
    return [_plan_level(groups, slot, chunk, mu, ladder)
            for groups in sched.levels]


def precompile_schedule(ctx: Context, sched: Schedule, batch: int,
                        level: int = 0) -> int:
    """Compile every distinct step shape `run_schedule` will need, on dummy
    data, so the timed run hits only cached executables (an AES-scale
    netlist needs only a handful of distinct shapes thanks to chunking).
    Returns the number of programs compiled."""
    if ctx.mesh is not None:
        return 0
    lvlp = ctx.params.lvl0 if level == 0 else ctx.params.lvl1
    width = lvlp.dim + 1
    mu = lvlp.mu
    slot = allocate_slots(sched)
    num_slots = max(slot.values()) + 1 if slot else 1
    if 0 < sched.num_gates <= _fuse_max():
        # mirror run_schedule's dispatch: small circuits run as ONE fused
        # program — warm that, not step shapes it will never use
        prog = _fused_program(ctx, sched, batch, level, slot, mu)
        regs = jnp.zeros((num_slots, batch, width), dtype=U32)
        outs = prog(regs, ctx.keys)
        np.asarray(jax.device_get(outs[0, 0, :1]))
        return 1
    chunk = _exec_chunk(batch)
    plans = _plan_schedule(sched, slot, chunk, mu)
    seen = set()
    sigs = []
    for plan in plans:
        for step in plan:
            if step[0] == "two":
                sig = ("two", step[1].shape[0])
            elif step[0] == "mux":
                sig = ("mux", step[1].shape[0], step[5])
            else:
                sig = ("lin", step[1].shape[0], step[3])
            if sig not in seen:
                seen.add(sig)
                sigs.append(step)
    fns = _step_fns(ctx, level)
    regs = jnp.zeros((num_slots, batch, width), dtype=U32)
    for step in sigs:
        regs = _apply_step(fns, regs, step, ctx.keys)
    np.asarray(jax.device_get(regs[0, 0, :1]))
    return len(sigs)


def _apply_step(fns, regs, step, keys):
    kind = step[0]
    if kind == "two":
        _, ina, inb, outs, c3 = step
        return fns["two"](regs, jnp.asarray(ina), jnp.asarray(inb),
                          jnp.asarray(outs), jnp.asarray(c3), keys)
    if kind == "mux":
        _, ic, i1, i0, outs, neg = step
        return fns["mux"](regs, jnp.asarray(ic), jnp.asarray(i1),
                          jnp.asarray(i0), jnp.asarray(outs), neg, keys)
    _, idx, outs, neg = step
    return fns["lin"](regs, jnp.asarray(idx), jnp.asarray(outs), neg)


def _fuse_max() -> int:
    """Gate-count ceiling for whole-schedule fusion (0 disables). Small
    circuits fuse into ONE XLA program — one dispatch per evaluation
    instead of one per level step, the dominant cost for adder-scale
    circuits. Large netlists stay on the chunked donated-step path: their
    per-dispatch cost is small and a 45k-gate single program would compile
    for hours."""
    return int(os.environ.get("CUFHE_FUSE_MAX", "512"))


def _schedule_body(ctx: Context, sched: Schedule, batch: int, lvl: int,
                   slot: Dict[int, int], mu: int):
    """Traceable function (regs, keys) -> regs running the ENTIRE schedule:
    every level's gather -> fused gate batch -> scatter inlined
    back-to-back on the register file. Shared by the one-shot fused
    program and the scanned feedback loop."""
    from ..ops import bootstrap as B
    p, bk = ctx.params, ctx.backend
    gate_fn = B.gate_lvl0 if lvl == 0 else B.gate_lvl1
    mux_fn = B.mux_lvl0 if lvl == 0 else B.mux_lvl1
    plans = _plan_schedule(sched, slot, _exec_chunk(batch), mu)

    def body(regs, keys):
        S, bsz, width = regs.shape
        for plan in plans:
            for step in plan:
                # index arrays are tiny compile-time constants; keys stay
                # a runtime argument (never bake big arrays into HLO)
                if step[0] == "two":
                    _, ina, inb, outs, c3 = step
                    gp = ina.shape[0]
                    ga = regs[ina].reshape(gp * bsz, width)
                    gb = regs[inb].reshape(gp * bsz, width)
                    c = jnp.repeat(jnp.asarray(c3), bsz, axis=0)
                    res = gate_fn(c, ga, gb, keys=keys, params=p,
                                  backend=bk)
                    regs = regs.at[outs].set(res.reshape(gp, bsz, width))
                elif step[0] == "mux":
                    _, ic, i1, i0, outs, neg = step
                    gp = ic.shape[0]
                    g = lambda x: regs[x].reshape(gp * bsz, width)
                    res = mux_fn(g(ic), g(i1), g(i0), keys, p,
                                 negate=bool(neg), backend=bk)
                    regs = regs.at[outs].set(res.reshape(gp, bsz, width))
                else:
                    _, idx, outs, neg = step
                    vals = regs[idx]
                    if neg:
                        vals = jnp.negative(vals)
                    regs = regs.at[outs].set(vals)
        return regs

    return body


def _fused_program(ctx: Context, sched: Schedule, batch: int, lvl: int,
                   slot: Dict[int, int], mu: int):
    """One jitted program running the ENTIRE schedule, returning the
    output rows. Cached per (schedule identity, batch)."""
    cache = ctx._cache.setdefault("fused_scheds", {})
    # key by the Schedule OBJECT (identity hash): the strong reference
    # pins it alive, so the key cannot be reused by a new schedule the
    # way a bare id() could after garbage collection
    key = (sched, batch, lvl)
    if key in cache:
        return cache[key]
    body = _schedule_body(ctx, sched, batch, lvl, slot, mu)
    out_rows = np.asarray([slot[w] for w in sched.outputs], dtype=np.int32)

    def whole(regs, keys):
        return body(regs, keys)[out_rows]

    # no donation: the output ([n_out, B, w]) cannot alias the register
    # file ([S, B, w]), and within one program XLA updates regs in place
    # anyway — donating would only emit "donated buffer not usable" noise
    prog = jax.jit(whole)
    cache[key] = prog
    return prog


def run_schedule_loop(ctx: Context, sched: Schedule, inputs: Sequence[Ctxt],
                      cycles: int, feedback: Sequence[Tuple[int, int]],
                      level: int = 0, segment: int = 0) -> List[Ctxt]:
    """Run a feedback circuit for `cycles` iterations as ONE compiled
    program (lax.scan over the whole schedule): each iteration, output
    `o` feeds input `i` for every (o, i) pair in `feedback`; all other
    inputs are re-presented unchanged (e.g. an encrypted ROM). Returns the
    final iteration's outputs.

    This is the latency path for sequential encrypted machines (the TOY8
    processor: a whole multi-cycle run costs ONE dispatch instead of
    cycles x levels round trips). Bit-identical to calling run_schedule
    in a Python loop and copying outputs to inputs. Requires the circuit
    to be under the fusion threshold (CUFHE_FUSE_MAX).

    Under a mesh Context the whole scanned loop runs as one shard_map
    program: the batch axis of every plane is sharded over the data axis,
    keys are replicated, and the feedback wiring stays device-local (zero
    collectives — same SPMD shape as run_schedule under mesh).

    `segment` (or env CUFHE_LOOP_SEG; 0 = all cycles in one dispatch)
    caps the cycles per device dispatch: the feedback planes are carried
    between dispatches, bit-identical to the single scan. Needed where
    the execution environment bounds single-dispatch duration; schedulers
    may also prefer shorter dispatches for preemption."""
    if not 0 < sched.num_gates <= _fuse_max():
        raise ValueError(f"schedule has {sched.num_gates} gates; the "
                         f"scanned loop needs 0 < gates <= {_fuse_max()} "
                         "(CUFHE_FUSE_MAX)")
    if len(inputs) != len(sched.inputs):
        raise ValueError(f"circuit has {len(sched.inputs)} inputs, "
                         f"got {len(inputs)}")
    n_out = len(sched.outputs)
    for o, i in feedback:
        if not (0 <= o < n_out and 0 <= i < len(inputs)):
            raise ValueError(f"feedback pair {(o, i)} out of range")
    B, width = inputs[0].data.shape
    lvl = inputs[0].level
    for ct in inputs:
        if ct.data.shape != (B, width) or ct.level != lvl:
            raise ValueError("all inputs must share shape and level")
    lvlp = ctx.params.lvl0 if lvl == 0 else ctx.params.lvl1
    mu = lvlp.mu

    slot = allocate_slots(sched)
    num_slots = max(slot.values()) + 1 if slot else 1
    in_rows = np.asarray([slot[w] for w in sched.inputs], dtype=np.int32)
    out_rows = np.asarray([slot[w] for w in sched.outputs], dtype=np.int32)
    fb_in = np.asarray([i for _, i in feedback], dtype=np.int32)
    fb_out = np.asarray([o for o, _ in feedback], dtype=np.int32)
    consts = [(slot[w], v) for w, v in sched.consts.items()]

    segment = segment or int(os.environ.get("CUFHE_LOOP_SEG", "0")) or cycles

    cache = ctx._cache.setdefault("fused_loops", {})

    def _loop_prog(n_cycles: int):
        key = (sched, B, lvl, n_cycles, tuple(map(tuple, feedback)))
        if key in cache:
            return cache[key]
        body = _schedule_body(ctx, sched, B, lvl, slot, mu)

        def loop(planes, keys):
            def cyc(pl, _):
                Bl = pl.shape[1]   # local batch (shard size under a mesh)
                regs = jnp.zeros((num_slots, Bl, width), dtype=U32)
                regs = regs.at[jnp.asarray(in_rows)].set(pl)
                for row, val in consts:
                    regs = regs.at[row].set(
                        trivial_ciphertext(val, width - 1, mu, Bl))
                regs = body(regs, keys)
                outs = regs[jnp.asarray(out_rows)]
                pl = pl.at[jnp.asarray(fb_in)].set(outs[jnp.asarray(fb_out)])
                return pl, outs
            planes, all_outs = jax.lax.scan(cyc, planes, None,
                                            length=n_cycles)
            # the carried planes come back to the host so a segmented run
            # can resume the NEXT dispatch where this one stopped
            return planes, all_outs[-1]

        if ctx.mesh is not None:
            from jax.sharding import PartitionSpec as _PS

            from ..parallel.mesh import DATA_AXIS
            ndev = int(ctx.mesh.devices.size)
            if B % ndev:
                raise ValueError(f"batch {B} not divisible by the "
                                 f"{ndev}-device mesh")
            # planes are [n_in, B, width]: shard axis 1 (the batch), keys
            # replicated; feedback is elementwise in the batch, so the
            # scanned body needs zero collectives (check_vma=False as in
            # parallel.mesh.data_parallel — bit-equality is tested).
            loop = jax.shard_map(
                loop, mesh=ctx.mesh,
                in_specs=(_PS(None, DATA_AXIS), _PS()),
                out_specs=(_PS(None, DATA_AXIS), _PS(None, DATA_AXIS)),
                check_vma=False)
        cache[key] = jax.jit(loop)
        return cache[key]

    planes = jnp.stack([ct.data for ct in inputs])
    if ctx.mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _PS

        from ..parallel.mesh import DATA_AXIS
        planes = jax.device_put(
            planes, NamedSharding(ctx.mesh, _PS(None, DATA_AXIS)))
    done = 0
    outs = None
    while done < cycles:
        c = min(segment, cycles - done)
        planes, outs = _loop_prog(c)(planes, ctx.keys)
        done += c
    return [Ctxt(outs[i], lvl) for i in range(n_out)]


def run_schedule(ctx: Context, sched: Schedule,
                 inputs: Sequence[Ctxt], level: int = 0) -> List[Ctxt]:
    """Execute a compiled circuit. inputs[i] feeds sched.inputs[i]; every
    input batch must share shape [B, dim+1]. Returns output Ctxts in
    declaration order.

    Small circuits (num_gates <= CUFHE_FUSE_MAX, default 512) run as ONE
    fused XLA program per evaluation; larger netlists run level-by-level
    through cached donated-register-file step programs."""
    if len(inputs) != len(sched.inputs):
        raise ValueError(f"circuit has {len(sched.inputs)} inputs, "
                         f"got {len(inputs)}")
    if not inputs and not sched.consts:
        return []
    if inputs:
        B, width = inputs[0].data.shape
        lvl = inputs[0].level
        for ct in inputs:
            if ct.data.shape != (B, width) or ct.level != lvl:
                raise ValueError("all inputs must share shape and level")
    else:
        raise ValueError("constant-only circuits need at least one input "
                         "to define the batch shape")
    mu = ctx.params.lvl0.mu if lvl == 0 else ctx.params.lvl1.mu

    # register file [num_slots, B, width] on device; slots recycle after a
    # wire's last read (peak liveness, not wire count — AES-scale netlists
    # would otherwise need ~90 GB)
    slot = allocate_slots(sched)
    num_slots = max(slot.values()) + 1 if slot else 1
    regs = jnp.zeros((num_slots, B, width), dtype=U32)
    # one stacked scatter for all inputs+consts: a per-input .at[].set loop
    # dispatches one XLA program per input (AES: 256, TOY8 ROM: 193), where
    # one scatter is a single dispatch
    rows = [slot[w] for w in sched.inputs]
    planes = [ct.data for ct in inputs]
    for wire, val in sched.consts.items():
        rows.append(slot[wire])
        planes.append(trivial_ciphertext(val, width - 1, mu, B))
    if rows:
        regs = regs.at[jnp.asarray(rows, dtype=jnp.int32)].set(
            jnp.stack(planes))

    if ctx.mesh is None:
        if 0 < sched.num_gates <= _fuse_max():
            # whole-schedule fusion: one dispatch per evaluation
            prog = _fused_program(ctx, sched, B, lvl, slot, mu)
            outs = prog(regs, ctx.keys)
            return [Ctxt(outs[i], lvl) for i in range(len(sched.outputs))]
        # fast path: donated-register-file step programs (gather + fused
        # gate batch + scatter in ONE XLA call each, register file aliased
        # in place), fixed-size chunks so a whole netlist compiles to a
        # handful of distinct programs
        fns = _step_fns(ctx, lvl)
        plans = _plan_schedule(sched, slot, _exec_chunk(B), mu)
        for plan in plans:
            for step in plan:
                regs = _apply_step(fns, regs, step, ctx.keys)
        return [Ctxt(regs[slot[w]], lvl) for w in sched.outputs]

    from ..golden import GATE_CONSTANTS
    two_input = {n for n in GATE_CONSTANTS
                 if n not in ("not", "copy", "mux", "nmux")}

    for groups in sched.levels:
        # gather → fused batched calls → scatter. ALL two-input gates of a
        # level (any mix of the ten ops) run as ONE program via per-row
        # gate constants; the gate count is bucket-padded so large netlists
        # reuse a handful of compiled shapes instead of one per level.
        updates = []
        fused_quads: List[tuple] = []
        fused_names: List[str] = []
        for opname, quads in groups:
            if opname in two_input:
                fused_quads.extend(quads)
                fused_names.extend([opname] * len(quads))
                continue
            outs = jnp.asarray([slot[q[0]] for q in quads], dtype=jnp.int32)
            ga = regs[jnp.asarray([slot[q[1]] for q in quads])]  # [L,B,width]
            L = ga.shape[0]
            flat = lambda x: x.reshape(L * B, width)
            unflat = lambda x: x.reshape(L, B, width)
            if opname in ("not", "copy"):
                a = Ctxt(flat(ga), lvl)
                res = ctx.not_(a) if opname == "not" else ctx.copy(a)
            else:  # mux / nmux
                gb = regs[jnp.asarray([slot[q[2]] for q in quads])]
                gc = regs[jnp.asarray([slot[q[3]] for q in quads])]
                res = ctx.mux(Ctxt(flat(ga), lvl), Ctxt(flat(gb), lvl),
                              Ctxt(flat(gc), lvl), negate=(opname == "nmux"))
            updates.append((outs, unflat(res.data)))
        if fused_quads:
            G = len(fused_quads)
            Gp = _bucket(G)
            pad = Gp - G
            quads_p = fused_quads + [fused_quads[0]] * pad
            names_p = fused_names + [fused_names[0]] * pad
            from ..ops.bootstrap import encode_gate_consts_rows
            c3 = encode_gate_consts_rows(names_p, mu)      # [Gp, 3]
            ga = regs[jnp.asarray([slot[q[1]] for q in quads_p])]
            gb = regs[jnp.asarray([slot[q[2]] for q in quads_p])]
            # [Gp, 3] tiles to gate-major rows on device (gate_rows)
            res = ctx.gate_rows(c3,
                                Ctxt(ga.reshape(Gp * B, width), lvl),
                                Ctxt(gb.reshape(Gp * B, width), lvl))
            outs = jnp.asarray([slot[q[0]] for q in quads_p],
                               dtype=jnp.int32)
            updates.append((outs, res.data.reshape(Gp, B, width)))
        for outs, vals in updates:
            regs = regs.at[outs].set(vals)

    return [Ctxt(regs[slot[w]], lvl) for w in sched.outputs]
