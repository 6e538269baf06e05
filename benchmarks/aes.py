"""Encrypted AES-128 on the GPU: the kvsp-class workload end-to-end.

Generates the Bristol AES-128 netlist (46,704 gates raw; the scheduler's
NOT/COPY-absorption pass reduces it to 45,760 gates over 257 levels),
schedules it with the native C++ core, and evaluates it over a batch of
encrypted blocks at the flagship TFHEpp 128-bit parameter set, verifying
every output block against plaintext AES. Reports blocks/s and effective
bootstraps/s (45,760 bootstrapped gates per block; INV/EQW are free).

Env: AES_BATCH (default 64), AES_PARAMS (default tfhepp_128bit).
Run: python benchmarks/aes.py
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
    from cufhe_jax import golden as G
    from cufhe_jax.models.api import Context, decrypt_bits, encrypt_bits
    from cufhe_jax.runtime import netlists as NL
    from cufhe_jax.runtime.bristol import compile_bristol
    from cufhe_jax.runtime.executor import precompile_schedule, run_schedule

    batch = int(os.environ.get("AES_BATCH", "64"))
    pname = os.environ.get("AES_PARAMS", "tfhepp_128bit")
    sk, ek = load_or_make_bench_keys(pname)

    print("generating + scheduling AES-128 netlist...", file=sys.stderr)
    sched, _ = compile_bristol(NL.aes128_bristol())
    n_bootstrapped = sum(len(q) for lvl in sched.levels for op, q in lvl
                         if op not in ("not", "copy"))

    ctx = Context(ek)
    rng = np.random.default_rng(11)
    pts = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
           for _ in range(batch)]
    keys = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            for _ in range(batch)]
    in_bits = np.array([NL.bits_of(p) + NL.bits_of(k)
                        for p, k in zip(pts, keys)]).T
    cts = [encrypt_bits(b, sk, rng) for b in in_bits]

    # compile every step shape up front, so the timed run hits only cached
    # executables. The reference's timings likewise exclude one-time setup
    # (keys/cudaMalloc).
    tc = time.perf_counter()
    n_progs = precompile_schedule(ctx, sched, batch)
    compile_s = time.perf_counter() - tc
    print(f"precompiled {n_progs} programs in {compile_s:.0f}s",
          file=sys.stderr)

    print(f"evaluating {sched.num_gates} gates x batch {batch} "
          f"({n_bootstrapped * batch} bootstraps)...", file=sys.stderr)
    t0 = time.perf_counter()
    outs = run_schedule(ctx, sched, cts)
    out_np = [np.asarray(jax.device_get(o.data)) for o in outs]
    dt = time.perf_counter() - t0

    out_bits = np.stack([G.decrypt_bit_batch(o, sk) for o in out_np])
    errors = 0
    for i, (p, k) in enumerate(zip(pts, keys)):
        if NL.bytes_of(out_bits[:, i]) != NL.aes128_encrypt_block(p, k):
            errors += 1

    rec = {
        "bench": "aes128",
        "params": pname,
        "batch": batch,
        "gates": sched.num_gates,
        "levels": sched.num_levels,
        "seconds": round(dt, 1),
        "blocks_per_sec": round(batch / dt, 3),
        "sec_per_block": round(dt / batch, 3),
        "bootstraps_per_sec": round(n_bootstrapped * batch / dt, 1),
        "compile_seconds": round(compile_s, 1),
        "block_errors": errors,
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(rec))
    append_result(rec)
    if errors:
        raise SystemExit(f"{errors} block errors")


if __name__ == "__main__":
    main()
