"""TOY8 encrypted processor on the GPU: encrypted-CPU cycles per second.

The reference's raison d'être is the Virtual Secure Platform's encrypted
processor (reference README.md:2-7). This benchmark steps the TOY8 cycle
circuit (fetch/decode/ALU/control, 296 gates of which 177 are mux — the
control-flow-heavy gate mix kvsp produces) over a batch of lanes, each
lane an independent encrypted program, and reports cycles/s, lane-cycles/s
and effective bootstraps/s (mux = 2 blind rotations, as the reference
counts it, test_gate_gpu.cc:43).

Env: PROC_BATCH (default 256), PROC_CYCLES (default 4),
     PROC_PARAMS (default tfhepp_128bit), PROC_FUSED=1 to evaluate each
     cycle as ONE whole-circuit XLA program instead of the level-step
     executor (one 296-bootstrap program: lower dispatch, heavier compile),
     PROC_SCAN=1 to run the ENTIRE multi-cycle execution as one scanned
     program (run_schedule_loop: one dispatch per run — the latency path).
Run: python benchmarks/processor.py
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    import jax


    from _keys import append_result, load_or_make_bench_keys
    from cufhe_jax.models import processor as TOY
    from cufhe_jax.models.api import Context
    from cufhe_jax.runtime.executor import precompile_schedule

    batch = int(os.environ.get("PROC_BATCH", "256"))
    cycles = int(os.environ.get("PROC_CYCLES", "4"))
    pname = os.environ.get("PROC_PARAMS", "tfhepp_128bit")
    fused = os.environ.get("PROC_FUSED", "0") == "1"
    scan = os.environ.get("PROC_SCAN", "0") == "1"
    if not (fused or scan):
        # the 296-gate cycle is under the whole-circuit fusion threshold,
        # but a one-program-per-cycle HLO carries ~470 blind rotations —
        # default to the proven level-step executor and precompile it
        os.environ["CUFHE_FUSE_MAX"] = "0"
    sk, ek = load_or_make_bench_keys(pname)

    cb, _ = TOY.build_cycle()
    sched = cb.compile()
    weight = {"mux": 2, "nmux": 2, "not": 0, "copy": 0}
    n_boot = sum(weight.get(op, 1) * len(q)
                 for lvl in sched.levels for op, q in lvl)

    ctx = Context(ek)
    rng = np.random.default_rng(5)
    ops = list(TOY.OPCODES)
    progs = [[(ops[rng.integers(len(ops))], int(rng.integers(256)))
              for _ in range(int(rng.integers(1, TOY.PROG_SLOTS + 1)))]
             for _ in range(batch)]
    inputs = TOY.encrypt_state(progs, sk, rng)

    tc = time.perf_counter()
    if scan:
        # warm the one scanned whole-run program (untimed)
        TOY.run_cycles(ctx, sched, inputs, cycles, scan=True)
        n_progs = 1
    else:
        n_progs = precompile_schedule(ctx, sched, batch)
    compile_s = time.perf_counter() - tc
    print(f"precompiled {n_progs} programs in {compile_s:.0f}s",
          file=sys.stderr)

    print(f"stepping {sched.num_gates}-gate cycle circuit x {cycles} "
          f"cycles x batch {batch}...", file=sys.stderr)
    t0 = time.perf_counter()
    state = TOY.run_cycles(ctx, sched, inputs, cycles, scan=scan)
    _ = [np.asarray(jax.device_get(ct.data)) for ct in state]
    dt = time.perf_counter() - t0

    acc, pc = TOY.decrypt_state(state, sk)
    errors = sum((int(acc[i]), int(pc[i])) != TOY.interpret(p, cycles)
                 for i, p in enumerate(progs))

    rec = {
        "bench": "toy8_processor",
        "mode": "scan" if scan else ("fused" if fused else "levels"),
        "params": pname,
        "batch": batch,
        "cycles": cycles,
        "gates_per_cycle": sched.num_gates,
        "levels": sched.num_levels,
        "seconds": round(dt, 1),
        "cycles_per_sec": round(cycles / dt, 3),
        "lane_cycles_per_sec": round(cycles * batch / dt, 1),
        "bootstraps_per_sec": round(n_boot * cycles * batch / dt, 1),
        "compile_seconds": round(compile_s, 1),
        "lane_errors": errors,
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(rec))
    append_result(rec)
    if errors:
        raise SystemExit(f"{errors} lane errors")


if __name__ == "__main__":
    main()
