"""Encrypted SHA-256 on the GPU: the second kvsp-class workload end-to-end.

Generates the one-block Bristol SHA-256 netlist (~114k gates), schedules
it with the native C++ core, and evaluates it over a batch of encrypted
padded message blocks at the flagship parameter set, verifying every
digest against hashlib. Reports blocks/s and effective bootstraps/s.

Env: SHA_BATCH (default 32), SHA_PARAMS (default tfhepp_128bit).
Run: python benchmarks/sha256.py
"""
from __future__ import annotations

import hashlib
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
    from cufhe_jax.models.api import Context, encrypt_bits
    from cufhe_jax.runtime import netlists as NL
    from cufhe_jax.runtime.bristol import compile_bristol
    from cufhe_jax.runtime.executor import precompile_schedule, run_schedule

    batch = int(os.environ.get("SHA_BATCH", "32"))
    pname = os.environ.get("SHA_PARAMS", "tfhepp_128bit")
    sk, ek = load_or_make_bench_keys(pname)

    print("generating + scheduling SHA-256 netlist...", file=sys.stderr)
    sched, _ = compile_bristol(NL.sha256_block_bristol())
    n_bootstrapped = sum(len(q) for lvl in sched.levels for op, q in lvl
                         if op not in ("not", "copy"))

    ctx = Context(ek)
    rng = np.random.default_rng(12)
    msgs = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
            for n in rng.integers(0, 56, batch)]
    in_bits = np.array([NL.bits_of(NL.sha256_pad(m)) for m in msgs]).T
    cts = [encrypt_bits(b, sk, rng) for b in in_bits]

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
    errors = sum(NL.bytes_of(out_bits[:, i]) != hashlib.sha256(m).digest()
                 for i, m in enumerate(msgs))

    rec = {
        "bench": "sha256",
        "params": pname,
        "batch": batch,
        "gates": sched.num_gates,
        "levels": sched.num_levels,
        "seconds": round(dt, 1),
        "blocks_per_sec": round(batch / dt, 3),
        "sec_per_block": round(dt / batch, 3),
        "bootstraps_per_sec": round(n_bootstrapped * batch / dt, 1),
        "compile_seconds": round(compile_s, 1),
        "digest_errors": errors,
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(rec))
    append_result(rec)
    if errors:
        raise SystemExit(f"{errors} digest errors")


if __name__ == "__main__":
    main()
