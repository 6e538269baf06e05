#!/usr/bin/env python3
"""Smoke test of the TFHE gate path on the GPU, at the 128-bit set, full size.

    python3 chip_smoke.py                     # every phase, one card
    python3 chip_smoke.py --compare-backends  # time conv, toeplitz and ntt
    python3 chip_smoke.py --devices 4         # sharded chain vs one card

The default run drives the main path through the user entry points at
TFHEPP_128 (n0=636, N=1024, l=3, Bgbit=6, KS t=8/basebit=2) with full-size
keys: set-up (keys, Context, compile), a golden check uint32-for-uint32
against the NumPy model (4 NAND, 2 XOR, 2 MUX), a 20-deep NAND chain at
batch 4096 (gates/s), a 20-deep chain at batch 1 (ms/gate), a 32-bit
ripple-adder netlist through the scheduler at batch 64 and a 32-bit
encrypted-integer add at batch 256, each decrypt-checked.

Every phase raises on failure, so any failure exits non-zero. There is no
CPU fallback: without a GPU the script exits non-zero before any phase.
The last line of standard output is the JSON result
{"ok": true, "device": {"platform", "kind", "count"}}; everything else goes
on earlier lines. Long outputs (timings, traces) are also written under
chiprun_out/.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

PARAMS = "tfhepp_128bit"
BATCH = 4096
DEPTH = 20
ADDER_BITS, ADDER_BATCH = 32, 64
INT_BITS, INT_BATCH = 32, 256
MESH_BATCH, MESH_DEPTH = 16384, 5
GOLDEN_COUNTS = {"nand": 4, "xor": 2, "mux": 2}
#: compare mode: cap on the seconds one backend's timed chain may take
CHAIN_BUDGET_S = 150.0


def log(msg: str) -> None:
    print(msg, flush=True)


def contract_line(platform: str, kind: str, count: int) -> str:
    """The result line: the last line of a successful run."""
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind, "count": count}})


def require_gpu():
    """jax.devices() on the GPU, or exit non-zero (no CPU fallback)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{devs[0].platform!r}); nothing was run")
    return devs


def card_lines() -> list:
    """`nvidia-smi --query-gpu=name,power.limit`, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _setup_paths() -> None:
    for p in (REPO, os.path.join(REPO, "benchmarks")):
        if p not in sys.path:
            sys.path.insert(0, p)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _block(ct):
    ct.data.block_until_ready()
    return ct


def _expect_chain(bits0, bits1, n_gates: int):
    import numpy as np
    want = np.asarray(bits0)
    for _ in range(n_gates):
        want = 1 - (want & bits1)
    return want


def _compile_gate(ctx, batch: int, level: int = 0):
    """Lower + compile the two-input gate program at `batch` (the program
    ctx.gate runs); returns (compiled, seconds)."""
    import jax
    import jax.numpy as jnp

    from cufhe_jax.ops import bootstrap as B

    p = ctx.params
    c3 = B.encode_gate_consts((1, 1, 1), p.lvl0.mu)
    arg = jax.ShapeDtypeStruct((batch, p.lvl0.dim + 1), jnp.uint32)
    prog = ctx.gate_program(level)
    return _timed(lambda: prog.lower(c3, arg, arg, ctx.keys).compile())


def _memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: unavailable"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(m, f, 0) / 2**20:.1f} MiB"
        for f in fields)


def _hlo_stats(compiled) -> dict:
    """What XLA made of the gate: library calls and ops left to XLA."""
    import re
    from collections import Counter
    text = compiled.as_text()
    return {
        "custom_calls": dict(Counter(
            re.findall(r'custom_call_target="([^"]+)"', text))),
        "convolution_ops": len(re.findall(r"\bconvolution\(", text)),
        "dot_ops": len(re.findall(r"\bdot\(", text)),
        "fusions": len(re.findall(r"\bfusion\(", text)),
        "while_loops": len(re.findall(r"\bwhile\(", text)),
    }


def _chain(ctx, a, b, depth: int):
    """`depth` dependent NANDs, device-resident; returns (out, seconds)."""
    def run():
        out = a
        for _ in range(depth):
            out = ctx.nand(out, b)
        return _block(out)
    return _timed(run)


def _write_out(name: str, obj) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(obj, f, indent=1)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(devs, cards):
    import jax

    from cufhe_jax.runtime import native_available
    log(f"[device] {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform}); jax {jax.__version__}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    for c in cards:
        log(f"[device] card: {c}")
    so = os.path.join(REPO, "cufhe_jax", "runtime", "_native",
                      "libcufhe_circuit.so")
    had = os.path.exists(so)
    ok, dt = _timed(native_available)
    how = ("loaded the existing build" if had else "built with g++") \
        if ok else "UNAVAILABLE, Python fallback"
    log(f"[device] native circuit scheduler: {how} ({dt:.2f} s)")


def phase_setup(backend: str = "auto", mesh=None):
    """Keys (cached at a gitignored path) and a Context, with the upload
    timed."""
    import jax

    from _keys import load_or_make_bench_keys
    from cufhe_jax.models import Context
    from cufhe_jax.ops.bootstrap import resolve_backend

    (sk, ek), dt = _timed(lambda: load_or_make_bench_keys(PARAMS))
    log(f"[setup] keys {PARAMS}: {dt:.2f} s (BK {ek.bk.nbytes / 2**20:.1f} "
        f"MiB u32, KSK {ek.ksk.nbytes / 2**20:.1f} MiB u32)")

    def build():
        ctx = Context(ek, backend=backend, mesh=mesh)
        jax.block_until_ready(ctx.keys)
        return ctx
    ctx, dt = _timed(build)
    kb = sum(x.nbytes for x in jax.tree_util.tree_leaves(ctx.keys))
    log(f"[setup] Context(backend={backend!r} -> "
        f"{resolve_backend(backend, ek.params)!r}): key prep + upload "
        f"{dt:.2f} s, {kb / 2**20:.1f} MiB of device keys")
    return sk, ek, ctx


def phase_compile(ctx, batch: int):
    compiled, dt = _compile_gate(ctx, batch)
    log(f"[compile] NAND program at batch {batch}: {dt:.2f} s")
    log(f"[compile] {_memory_line(compiled)}")
    return compiled


def phase_golden(ctx, samples, pad_to: int):
    from golden_check import device_diff
    per, dt = _timed(lambda: device_diff(ctx, samples, pad_to=pad_to))
    for name, (m, t) in per.items():
        log(f"[golden] {name}: {m} mismatched uint32 words of {t} "
            f"({samples[name][1].shape[0]} samples, batch {pad_to})")
    log(f"[golden] device run incl. compile: {dt:.2f} s")
    bad = sum(m for m, _ in per.values())
    if bad:
        raise AssertionError(f"golden check: {bad} mismatched words")


def _chain_inputs(sk, batch: int, seed: int):
    import numpy as np

    from cufhe_jax.models import encrypt_bits
    rng = np.random.default_rng(seed)
    bits0 = rng.integers(0, 2, batch)
    bits1 = rng.integers(0, 2, batch)
    return (bits0, bits1, encrypt_bits(bits0, sk, rng),
            encrypt_bits(bits1, sk, rng))


def phase_chain(ctx, sk, batch: int, depth: int, card: str, tag: str):
    """Warm-up gate, then a timed `depth`-deep chain; every row
    decrypt-checked. Returns seconds per gate."""
    import numpy as np

    from cufhe_jax.models import decrypt_bits
    bits0, bits1, a, b = _chain_inputs(sk, batch, seed=batch)
    first, dt0 = _timed(lambda: _block(ctx.nand(a, b)))
    out, dt = _chain(ctx, first, b, depth)
    errs = int(np.sum(decrypt_bits(out, sk) !=
                      _expect_chain(bits0, bits1, depth + 1)))
    per_gate = dt / depth
    log(f"[{tag}] batch {batch}: first gate (compile+run) {dt0:.2f} s; "
        f"{depth}-deep chain {dt:.3f} s = {per_gate * 1e3:.3f} ms/gate, "
        f"{batch / per_gate:.1f} gates/s, {errs} decrypt errors of "
        f"{batch} rows [{card}]")
    if errs:
        raise AssertionError(f"{tag}: {errs} decrypt errors")
    return per_gate


def phase_adder(ctx, sk):
    import numpy as np

    from cufhe_jax.models import decrypt_bits, encrypt_bits
    from cufhe_jax.runtime import (build_ripple_adder, native_available,
                                   run_schedule)
    rng = np.random.default_rng(5)
    n, B = ADDER_BITS, ADDER_BATCH
    cb, _ = build_ripple_adder(n)
    sched = cb.compile()
    x = rng.integers(0, 1 << n, B, dtype=np.uint64)
    y = rng.integers(0, 1 << n, B, dtype=np.uint64)
    bit = lambda v, i: ((v >> np.uint64(i)) & np.uint64(1)).astype(int)
    ins = ([encrypt_bits(bit(x, i), sk, rng) for i in range(n)]
           + [encrypt_bits(bit(y, i), sk, rng) for i in range(n)]
           + [encrypt_bits(np.zeros(B, dtype=int), sk, rng)])

    def run():
        outs = run_schedule(ctx, sched, ins)
        outs[-1].data.block_until_ready()
        return outs
    outs, dt = _timed(run)
    got = sum(decrypt_bits(o, sk).astype(np.uint64) << np.uint64(i)
              for i, o in enumerate(outs))
    errs = int(np.sum(got != x + y))
    log(f"[netlist] {n}-bit ripple adder ({sched.num_gates} gates, "
        f"{sched.num_levels} levels) at batch {B} via run_schedule, "
        f"{'native C++' if native_available() else 'Python fallback'} "
        f"scheduler: {dt:.2f} s incl. compile, {errs} wrong "
        f"sums of {B}")
    if errs:
        raise AssertionError(f"ripple adder: {errs} wrong sums")


def phase_integers(ctx, sk):
    import numpy as np

    from cufhe_jax.models import IntContext, decrypt_uint, encrypt_uint
    rng = np.random.default_rng(6)
    mod = 1 << INT_BITS
    xs = [int(v) for v in rng.integers(0, mod, INT_BATCH, dtype=np.uint64)]
    ys = [int(v) for v in rng.integers(0, mod, INT_BATCH, dtype=np.uint64)]
    x = encrypt_uint(xs, INT_BITS, sk, rng=rng)
    y = encrypt_uint(ys, INT_BITS, sk, rng=rng)
    ictx = IntContext(ctx)

    def run():
        s = ictx.add(x, y)
        s.digits.block_until_ready()
        return s
    s, dt = _timed(run)
    got = decrypt_uint(s, sk)
    errs = sum(g != (a + b) % mod for g, a, b in zip(got, xs, ys))
    log(f"[integers] {INT_BITS}-bit IntContext.add (pbs_many) at batch "
        f"{INT_BATCH}: {dt:.2f} s incl. compile, {errs} wrong sums")
    if errs:
        raise AssertionError(f"integer add: {errs} wrong sums")


# ---------------------------------------------------------------------------
# Modes
# ---------------------------------------------------------------------------

def run_default(devs, cards):
    import numpy as np

    from golden_check import golden_samples
    card = cards[0]
    phase_device(devs, cards)
    sk, ek, ctx = phase_setup()
    phase_compile(ctx, BATCH)
    samples, dt = _timed(lambda: golden_samples(
        sk, ek, np.random.default_rng(23), GOLDEN_COUNTS))
    log(f"[golden] NumPy reference outputs: {dt:.2f} s")
    phase_golden(ctx, samples, pad_to=BATCH)
    per_gate = phase_chain(ctx, sk, BATCH, DEPTH, card, "throughput")
    lat = phase_chain(ctx, sk, 1, DEPTH, card, "latency")
    phase_adder(ctx, sk)
    phase_integers(ctx, sk)
    _write_out("chip_smoke.json", {
        "card": card, "backend": ctx.backend,
        "gates_per_s_b4096": BATCH / per_gate, "ms_per_gate_b1": lat * 1e3})


def _trace(ctx, sk, batch: int, name: str) -> dict:
    """Profile one NAND at `batch` (already compiled) and reduce it."""
    import jax

    from trace_summary import device_events, newest_xplane, summarize
    _, _, a, b = _chain_inputs(sk, batch, seed=batch + 1)
    _block(ctx.nand(a, b))
    d = os.path.join(OUT_DIR, "traces", name)
    with jax.profiler.trace(d):
        _block(ctx.nand(a, b))
    return summarize(device_events(newest_xplane(d)))


def compare_backend(name, sk, ek, samples, card, n0: int) -> dict:
    import jax

    from cufhe_jax.models import Context
    from golden_check import device_diff
    rec = {"backend": name, "card": card}

    def build():
        ctx = Context(ek, backend=name)
        jax.block_until_ready(ctx.keys)
        return ctx
    ctx, rec["setup_s"] = _timed(build)
    compiled, rec["compile_s"] = _compile_gate(ctx, BATCH)
    rec["memory"] = _memory_line(compiled)
    rec["hlo"] = _hlo_stats(compiled)
    log(f"[{name}] compile {rec['compile_s']:.2f} s; {rec['memory']}; "
        f"hlo {rec['hlo']}")
    per, rec["golden_run_s"] = _timed(
        lambda: device_diff(ctx, samples, pad_to=BATCH))
    rec["golden"] = per
    rec["bit_exact"] = all(m == 0 for m, _ in per.values())
    log(f"[{name}] golden {per} (bit-exact: {rec['bit_exact']})")
    _, _, a, b = _chain_inputs(sk, BATCH, seed=BATCH)
    first = _block(ctx.nand(a, b))
    _, one = _timed(lambda: _block(ctx.nand(first, b)))
    depth = DEPTH if one * DEPTH <= CHAIN_BUDGET_S else \
        max(1, int(CHAIN_BUDGET_S // one))
    _, dt = _chain(ctx, first, b, depth)
    rec.update(chain_depth_b4096=depth, ms_per_gate_b4096=dt / depth * 1e3,
               gates_per_s_b4096=BATCH * depth / dt)
    log(f"[{name}] batch {BATCH}: {depth}-deep chain {dt:.3f} s = "
        f"{BATCH * depth / dt:.1f} gates/s [{card}]")
    _, _, a1, b1 = _chain_inputs(sk, 1, seed=1)
    _, rec["first_call_b1_s"] = _timed(lambda: _block(ctx.nand(a1, b1)))
    _, dt = _chain(ctx, a1, b1, DEPTH)
    rec["ms_per_gate_b1"] = dt / DEPTH * 1e3
    log(f"[{name}] batch 1: {DEPTH}-deep chain {dt * 1e3 / DEPTH:.3f} "
        f"ms/gate [{card}]")
    for batch in (1, BATCH):
        tr = _trace(ctx, sk, batch, f"{name}_b{batch}")
        tr["kernels_per_cmux_step"] = tr.get("events", 0) / n0
        rec[f"trace_b{batch}"] = tr
        log(f"[{name}] trace batch {batch}: {tr}")
    ctx.release_keys()
    return rec


def run_compare(devs, cards):
    import numpy as np

    from _keys import load_or_make_bench_keys
    from cufhe_jax.ops.bootstrap import BACKENDS, resolve_backend
    from golden_check import golden_samples
    phase_device(devs, cards)
    sk, ek = load_or_make_bench_keys(PARAMS)
    counts = {"nand": GOLDEN_COUNTS["nand"], "xor": GOLDEN_COUNTS["xor"]}
    samples, dt = _timed(lambda: golden_samples(
        sk, ek, np.random.default_rng(23), counts))
    log(f"[golden] NumPy reference outputs: {dt:.2f} s")
    recs, failed = [], []
    for name in BACKENDS:
        try:
            recs.append(compare_backend(name, sk, ek, samples, cards[0],
                                        ek.params.lvl0.dim))
        except Exception as e:   # a backend XLA refuses is a finding
            traceback.print_exc()
            failed.append(name)
            recs.append({"backend": name, "error": f"{type(e).__name__}: "
                         f"{str(e)[:2000]}"})
            log(f"[{name}] FAILED: {recs[-1]['error']}")
        _write_out("compare_backends.json", recs)
    exact = [r for r in recs if r.get("bit_exact")]
    if exact:
        best = max(exact, key=lambda r: r["gates_per_s_b4096"])["backend"]
        auto = resolve_backend("auto", ek.params)
        log(f"[compare] fastest bit-exact at batch {BATCH}: {best}; "
            f"'auto' resolves to {auto}")
    if failed:
        raise SystemExit(f"compare: backends failed: {failed}")


def run_mesh(devs, cards, n: int):
    import jax
    import numpy as np

    from cufhe_jax.models import Context, decrypt_bits
    from cufhe_jax.parallel.mesh import data_mesh
    if len(devs) < n:
        raise SystemExit(f"--devices {n}: only {len(devs)} GPUs")
    phase_device(devs, cards)
    sk, ek, ctx_m = phase_setup(mesh=data_mesh(n_devices=n))
    ctx_1 = Context(ek)
    bits0, bits1, a, b = _chain_inputs(sk, MESH_BATCH, seed=MESH_BATCH)
    res = {}
    for tag, ctx in (("1 card", ctx_1), (f"{n} cards", ctx_m)):
        first, dt0 = _timed(lambda: _block(ctx.nand(a, b)))
        out, dt = _chain(ctx, first, b, MESH_DEPTH)
        res[tag] = np.asarray(jax.device_get(out.data))
        errs = int(np.sum(decrypt_bits(out, sk) != _expect_chain(
            bits0, bits1, MESH_DEPTH + 1)))
        log(f"[mesh] {tag}: batch {MESH_BATCH}, first gate {dt0:.2f} s, "
            f"{MESH_DEPTH}-deep chain {dt:.3f} s = "
            f"{MESH_BATCH * MESH_DEPTH / dt:.1f} gates/s, {errs} decrypt "
            f"errors, output on {len(out.data.sharding.device_set)} "
            f"device(s)")
        if errs:
            raise AssertionError(f"mesh {tag}: {errs} decrypt errors")
    mism = int(np.sum(res["1 card"] != res[f"{n} cards"]))
    log(f"[mesh] {n} cards vs 1 card: {mism} mismatched uint32 words of "
        f"{res['1 card'].size}")
    if mism:
        raise AssertionError(f"mesh: {mism} words differ from one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare-backends", action="store_true",
                    help="time conv, toeplitz and ntt (and nothing else)")
    ap.add_argument("--devices", type=int, default=1,
                    help="N > 1: shard a NAND chain over N cards and "
                         "compare it with one card (and nothing else)")
    args = ap.parse_args(argv)
    devs = require_gpu()
    _setup_paths()
    from cufhe_jax.utils import compcache
    cache = compcache.enable()
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"[setup] compile cache {cache}: {n_cached} entries at start "
        f"({'warm' if n_cached else 'cold'})")
    cards = card_lines()
    if args.devices > 1:
        run_mesh(devs, cards, args.devices)
    elif args.compare_backends:
        run_compare(devs, cards)
    else:
        run_default(devs, cards)
    for c in cards:
        print(c)
    print(contract_line(devs[0].platform, devs[0].device_kind, len(devs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
