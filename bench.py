"""Headline benchmark: batched NAND gate bootstraps/sec on one GPU at the
TFHEpp 128-bit parameter set (the reference's headline metric; cuFHE
README.md:29-31 reports 13 ms/gate single-stream on an A100).

    python bench.py

One process opens the card once and prints ONE JSON line naming the
metric, the device (platform, device_kind, count) and the card's power
limit. Without a GPU it exits non-zero and measures nothing.

Knobs (environment): BENCH_BATCH (4096), BENCH_ITERS (20 gates per timed
chain), BENCH_REPS (5), BENCH_BACKEND ("auto"), BENCH_PARAMS (a preset
name; default the 128-bit set), BENCH_FUSED=1 (each chain as ONE compiled
program, Context.gate_chain).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
_METRIC = "nand_gate_bootstraps_per_sec"


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.splitlines()[0].strip()


def main() -> int:
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: no GPU (JAX platform {devs[0].platform!r}); "
              "nothing measured", file=sys.stderr)
        return 1
    for p in (_REPO, os.path.join(_REPO, "benchmarks")):
        sys.path.insert(0, p)
    from _keys import load_or_make_bench_keys
    from cufhe_jax.models import Context, decrypt_bits, encrypt_bits
    from cufhe_jax.ops.bootstrap import resolve_backend

    batch = int(os.environ.get("BENCH_BATCH", "4096"))
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    backend = os.environ.get("BENCH_BACKEND", "auto")
    pname = os.environ.get("BENCH_PARAMS", "tfhepp_128bit")
    fused = os.environ.get("BENCH_FUSED", "0") == "1"

    sk, ek = load_or_make_bench_keys(pname)
    ctx = Context(ek, backend=backend)
    rng = np.random.default_rng(7)
    bits0 = rng.integers(0, 2, batch)
    bits1 = rng.integers(0, 2, batch)
    a = encrypt_bits(bits0, sk, rng)
    b = encrypt_bits(bits1, sk, rng)

    def chain(x):
        if fused:
            return ctx.gate_chain("nand", x, b, iters)
        for _ in range(iters):
            x = ctx.nand(x, b)   # chain on outputs: device-resident
        return x

    out = ctx.nand(a, b)         # compile + warm up
    if fused:
        out = chain(out)
    out.data.block_until_ready()
    gates_done = 1 + (iters if fused else 0)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = chain(out)
        out.data.block_until_ready()
        times.append((time.perf_counter() - t0) / iters)
        gates_done += iters
    dt = sorted(times)[len(times) // 2]

    want = np.asarray(bits0)
    for _ in range(gates_done):
        want = 1 - (want & bits1)
    errors = int(np.sum(decrypt_bits(out, sk) != want))
    print(json.dumps({
        "metric": _METRIC,
        "value": batch / dt,
        "unit": "gates/s",
        "batch": batch,
        "ms_per_batch": dt * 1e3,
        "backend": resolve_backend(backend, ek.params),
        "fused_chain": fused,
        "params": pname,
        "reps": reps,
        "decrypt_errors": errors,
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": _card(),
    }))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
