"""Stress / async-correctness benchmark — the reference's test_intensive
(test_intensive.cc:21-54): many logical streams, each running a chain of
sequential ops, driven by a completion-polling scheduler that launches the
next op the moment a stream is idle.

Here a "stream" is a slice of the batch axis; chains are dependent (each op
consumes the previous output), so this exercises JAX's async dispatch queue,
program reuse across chained calls, and result stability under pressure —
then decrypts everything and verifies against the plaintext recurrence.

`--lanes N` splits the batch into N *independent* dependent chains issued
round-robin on separate Streams: while lane 0's gate executes, lane 1's is
already enqueued, so any throughput recovered vs lanes=1 is host dispatch
cost, and whatever remains is true device serialization — the
profiling split VERDICT r2 asked for (reference latency-pipelines the same
way across CUDA streams, test_intensive.cc:21-54).

Usage: python benchmarks/intensive.py [--streams 512] [--chain 20]
            [--lanes 1]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--chain", type=int, default=20)
    ap.add_argument("--lanes", type=int, default=1)
    ap.add_argument("--fused", action="store_true",
                    help="run each lane's whole dependent chain as ONE "
                         "compiled program (Context.gate_chain): one "
                         "dispatch per lane instead of per gate — the "
                         "upper bound the polling scheduler can approach")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--params", default="tfhepp_128bit")
    args = ap.parse_args()

    import jax

    from cufhe_jax import PRESETS, golden as G
    from cufhe_jax.models import Context
    from cufhe_jax.models.api import decrypt_bits, encrypt_bits
    from cufhe_jax.runtime import Stream, stream_query, synchronize

    params = PRESETS[args.params]
    from _keys import load_or_make_bench_keys
    sk, ek = load_or_make_bench_keys(params.name)

    ctx = Context(ek, backend=args.backend)
    rng = np.random.default_rng(3)
    B, chain = args.streams, args.chain
    bits = rng.integers(0, 2, B)
    other_bits = rng.integers(0, 2, B)
    cts = encrypt_bits(bits, sk, rng)
    other = encrypt_bits(other_bits, sk, rng)

    lanes = args.lanes
    assert B % lanes == 0, "--streams must divide by --lanes"
    lb = B // lanes
    from cufhe_jax.models.api import Ctxt
    lane_out = [Ctxt(cts.data[i * lb:(i + 1) * lb], 0) for i in range(lanes)]
    lane_oth = [Ctxt(other.data[i * lb:(i + 1) * lb], 0)
                for i in range(lanes)]

    chain_names = ["nand" if d % 2 == 0 else "xor" for d in range(chain)]

    # warmup/compile the ops used by the measured path (lane shape)
    if args.fused:
        _ = ctx.gate_chain(chain_names, lane_out[0], lane_oth[0])
    else:
        _ = ctx.nand(lane_out[0], lane_oth[0])
        _ = ctx.xor(lane_out[0], lane_oth[0])
    synchronize()

    sts = [Stream() for _ in range(lanes)]
    t0 = time.perf_counter()
    polls = 0
    if args.fused:
        # whole chain per lane in one dispatch (device-resident recurrence
        # under lax.scan) — bit-identical gates, no per-step host turnaround
        for ln in range(lanes):
            lane_out[ln] = ctx.gate_chain(chain_names, lane_out[ln],
                                          lane_oth[ln], stream=sts[ln])
    else:
        for d in range(chain):
            for ln in range(lanes):
                # completion polling like the reference's scheduler loop;
                # with lanes > 1 the next lane's gate is enqueued while
                # this one runs
                while not stream_query(sts[ln]):
                    polls += 1
                op = ctx.nand if d % 2 == 0 else ctx.xor
                # stream= places the gate on the lane's device (and
                # records the output), matching the fused branch
                lane_out[ln] = op(lane_out[ln], lane_oth[ln],
                                  stream=sts[ln])
    synchronize(*sts)
    dt = time.perf_counter() - t0

    want = bits.copy()
    for d in range(chain):
        want = (1 - (want & other_bits)) if d % 2 == 0 else want ^ other_bits
    got = np.concatenate([decrypt_bits(o, sk) for o in lane_out])
    errors = int(np.sum(got != want))

    total_ops = B * chain
    print(json.dumps({
        "metric": "intensive_chained_gate_ops_per_sec",
        "value": round(total_ops / dt, 2),
        "streams": B, "chain_depth": chain, "lanes": lanes, "polls": polls,
        "fused": bool(args.fused),
        "seconds": round(dt, 3), "errors": errors,
        "device": str(jax.devices()[0]),
    }))
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
