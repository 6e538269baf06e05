"""Full benchmark suite — the analogue of the reference's benchmark binaries:

  gates    all 10 two-input bootstrapped gates + Mux/NMux + Not/Copy,
           both ciphertext levels      (reference test_gate_gpu.cc:42-83)
  chain    16-deep dependent NAND chain fused into one program
           (gate_chain) — per-gate device rate, dispatch amortized
  refresh  TRLWE->TRLWE noise refresh  (reference test_perf.cc:18-87)
  cmux     TRGSW-select on TRLWE pairs (reference test_cmux.cc:42-126)
  kernels  blind-rotate-only and keyswitch-only microbenchmarks
  noise    phase-noise margin measurement, FAILS RED below the documented
           floor (MARGIN_FLOORS in noise.py) — perf changes cannot
           silently regress correctness margins

Each section verifies decryptions against the plaintext oracles
(reference test/plain.h) before reporting. Writes one JSON object per
measurement to benchmarks/results.jsonl and prints a table.

Usage: python benchmarks/suite.py [--batch 1024] [--iters 2]
            [--backend auto] [--params tfhepp_128bit]
            [--sections gates,mux,linear,refresh,cmux,kernels]
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

def _force(out):
    """Block until a result (Ctxt/TrlweCtxt/array/tuple) is really done.
    Fetches a tiny dependent slice, not the whole array: a full-output
    readback would bill D2H transfer to the op being timed (lvl1 outputs
    are 8 MB/batch; the reference times kernels with cudaEvents, D2H
    excluded)."""
    import jax
    if isinstance(out, tuple):
        out = out[0]
    arr = getattr(out, "data", out)
    np.asarray(jax.device_get(arr[..., :4]))


def timed(fn, iters):
    out = fn()                       # warmup / compile
    _force(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _force(out)
    return (time.perf_counter() - t0) / iters, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--params", default="tfhepp_128bit")
    ap.add_argument("--sections",
                    default="golden,gates,chain,latency,mux,linear,refresh,"
                            "cmux,kernels,noise")
    args = ap.parse_args()
    sections = set(args.sections.split(","))

    import jax
    import jax.numpy as jnp

    from cufhe_jax import PRESETS, golden as G
    from cufhe_jax.models import Context
    from cufhe_jax.models.api import TrlweCtxt, decrypt_bits, encrypt_bits

    params = PRESETS[args.params]
    from _keys import load_or_make_bench_keys
    sk, ek = load_or_make_bench_keys(params.name)

    ctx = Context(ek, backend=args.backend)
    rng = np.random.default_rng(7)
    B = args.batch
    dev = str(jax.devices()[0])
    results = []
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "results.jsonl")

    def report(section, name, dt, ops, errors, level=None):
        rec = {"section": section, "name": name, "ops_per_sec":
               round(ops / dt, 2), "ms_per_batch": round(dt * 1e3, 3),
               "batch": ops, "errors": int(errors), "backend": args.backend,
               "params": params.name, "device": dev}
        if level is not None:
            rec["level"] = level
        results.append(rec)
        with open(out_path, "a") as f:   # incremental: survive crashes
            f.write(json.dumps(rec) + "\n")
        print(f"{section:8s} {name:8s} lvl{level if level is not None else '-'}"
              f"  {rec['ops_per_sec']:>10.1f} ops/s   "
              f"{rec['ms_per_batch']:>9.2f} ms/batch   errors={errors}")

    bits0 = rng.integers(0, 2, B)
    bits1 = rng.integers(0, 2, B)
    bits2 = rng.integers(0, 2, B)

    if "golden" in sections:
        # hardware bit-exactness as a TESTED property: uint32-for-uint32
        # diff of device gates vs the golden model ON THIS DEVICE (what the
        # device compiler makes of the program is what CPU tests cannot
        # exercise)
        from golden_check import golden_diff
        t0 = time.perf_counter()
        mism, total = golden_diff(ctx, sk, ek, rng)
        report("golden", "u32_diff", time.perf_counter() - t0, total, mism)
        if mism:
            print("DEVICE OUTPUT != GOLDEN MODEL — failing red",
                  file=sys.stderr)

    if "gates" in sections:
        for level in (0, 1):
            a = encrypt_bits(bits0, sk, rng, level=level)
            b = encrypt_bits(bits1, sk, rng, level=level)
            for name in G.GATE_CONSTANTS:
                dt, out = timed(lambda: ctx.gate(name, a, b), args.iters)
                got = decrypt_bits(out, sk)
                want = G.PLAIN_GATES[name](bits0, bits1)
                report("gates", name, dt, B, np.sum(got != want), level)

    if "chain" in sections:
        # device-rate truth: a 16-deep dependent NAND chain fused into ONE
        # program (Context.gate_chain) — per-gate time with the per-call
        # dispatch tax amortized 16x, the closest analogue of the
        # reference's cudaEvent kernel timing (test_util.h:30-72)
        depth = 16
        for level in (0, 1):
            a = encrypt_bits(bits0, sk, rng, level=level)
            b = encrypt_bits(bits1, sk, rng, level=level)
            dt, out = timed(lambda: ctx.gate_chain("nand", a, b, depth),
                            args.iters)
            got = decrypt_bits(out, sk)
            want = bits0.copy()
            for _ in range(depth):
                want = 1 - (want & bits1)
            report("chain", f"nand_x{depth}", dt / depth, B,
                   np.sum(got != want), level)

    if "latency" in sections:
        # Small-batch latency — the reference's single-stream number is
        # 13 ms/gate on A100 (README.md:29-31). Two views per batch size:
        #   * b{B}: one dispatch, full enqueue+sync round trip included
        #     (an upper bound on true device latency).
        #   * b{B}_chain: 20 DEPENDENT gates, one final force — per-gate
        #     device latency with the per-sync tax amortized; this is the
        #     number a sequential encrypted machine (TOY8) actually pays
        #     per gate level.
        lat_depth = 20
        for Bs in (1, 64, 256):
            lb0 = rng.integers(0, 2, Bs)
            lb1 = rng.integers(0, 2, Bs)
            a = encrypt_bits(lb0, sk, rng)
            b = encrypt_bits(lb1, sk, rng)
            out = ctx.nand(a, b)            # compile
            _force(out)
            ts = []
            for _ in range(max(args.iters, 5)):
                t0 = time.perf_counter()
                out = ctx.nand(a, b)
                _force(out)
                ts.append(time.perf_counter() - t0)
            dt = sorted(ts)[len(ts) // 2]   # median single dispatch
            got = decrypt_bits(out, sk)
            report("latency", f"b{Bs}", dt, Bs,
                   np.sum(got != (1 - (lb0 & lb1))))
            ts = []
            for _ in range(max(args.iters, 3)):
                out = ctx.nand(a, b)
                t0 = time.perf_counter()
                for _ in range(lat_depth):
                    out = ctx.nand(out, b)
                _force(out)
                ts.append((time.perf_counter() - t0) / lat_depth)
            dt = sorted(ts)[len(ts) // 2]
            want = 1 - (lb0 & lb1)
            for _ in range(lat_depth):
                want = 1 - (want & lb1)
            got = decrypt_bits(out, sk)
            report("latency", f"b{Bs}_chain", dt, Bs, np.sum(got != want))

    if "mux" in sections:
        for level in (0, 1):
            c = encrypt_bits(bits2, sk, rng, level=level)
            a = encrypt_bits(bits0, sk, rng, level=level)
            b = encrypt_bits(bits1, sk, rng, level=level)
            for name, neg in (("mux", False), ("nmux", True)):
                dt, out = timed(lambda: ctx.mux(c, a, b, negate=neg),
                                args.iters)
                got = decrypt_bits(out, sk)
                want = np.where(bits2 == 1, bits0, bits1)
                if neg:
                    want = 1 - want
                report("mux", name, dt, B, np.sum(got != want), level)

    if "linear" in sections:
        a = encrypt_bits(bits0, sk, rng)
        dt, out = timed(lambda: ctx.not_(a), max(args.iters, 10))
        report("linear", "not", dt, B,
               np.sum(decrypt_bits(out, sk) != 1 - bits0), 0)

    if "refresh" in sections:
        # test_perf analogue: refresh a batch of TRLWEs carrying test bits
        a = encrypt_bits(bits0, sk, rng)
        tr = ctx.bootstrap_tlwe2trlwe(a)
        dt, out = timed(lambda: ctx.refresh(tr), args.iters)
        got = np.array([G.trlwe_phase(np.asarray(t), params.lvl1, sk.lvl1)[0]
                        for t in np.asarray(jax.device_get(out.data))])
        errors = np.sum((got.astype(np.int32) > 0) != bits0)
        report("refresh", "refresh", dt, B, errors)

    if "cmux" in sections:
        plain1 = rng.integers(0, 2, params.lvl1.n)
        trgsw1 = G.trgsw_encrypt(1, params.lvl1, sk.lvl1, rng)
        tg = ctx.prepare_trgsw(trgsw1)
        c1 = np.stack([G.trlwe_encrypt_bits(plain1, params.lvl1, sk.lvl1,
                                            rng) for _ in range(B // 8)])
        c0 = np.stack([G.trlwe_encrypt_bits(1 - plain1, params.lvl1, sk.lvl1,
                                            rng) for _ in range(B // 8)])
        c1j, c0j = jnp.asarray(c1), jnp.asarray(c0)
        dt, out = timed(lambda: ctx.cmux(tg, TrlweCtxt(c1j), TrlweCtxt(c0j)),
                        args.iters)
        ph = G.trlwe_phase(np.asarray(jax.device_get(out.data))[0],
                           params.lvl1, sk.lvl1)
        errors = np.sum((ph.astype(np.int32) > 0) != plain1)
        report("cmux", "cmux", dt, B // 8, errors)

    if "kernels" in sections:
        from cufhe_jax.ops import bootstrap as BS
        from cufhe_jax.ops.keyswitch import key_switch
        a = encrypt_bits(bits0, sk, rng)
        import jax as _j
        # keys must be *arguments*, not closed-over constants, or they get
        # baked into the HLO as literals
        br = _j.jit(lambda x, k: BS.bootstrap_tlwe2trlwe(
            x, params.lvl1.mu, k, params, args.backend))
        dt, _ = timed(lambda: br(a.data, ctx.keys), args.iters)
        report("kernels", "blindrot", dt, B, 0)
        d1 = params.lvl1.k * params.lvl1.n
        tl = jnp.asarray(rng.integers(0, 1 << 32, size=(B, d1 + 1),
                                      dtype=np.uint64).astype(np.uint32))
        ks = _j.jit(lambda x, kl: key_switch(x, kl, params))
        dt, _ = timed(lambda: ks(tl, ctx.keys.ksk_limbs), args.iters)
        report("kernels", "keyswitch", dt, B, 0)

    margin_fail = 0
    if "noise" in sections:
        from noise import (INT_MARGIN_FLOORS, MARGIN_FLOORS, margin_ok,
                           measure_int_adder_noise, measure_noise)
        rec = measure_noise(params, args.backend, batch=max(B, 2048),
                            ek=ek, sk=sk)
        rec["section"] = "noise"
        floor = MARGIN_FLOORS.get(params.name)
        rec["margin_floor_sigmas"] = floor
        results.append(rec)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        sig = rec["worst_gate_margin_sigmas"]
        xerr = rec["xor_of_bootstrapped_errors"]
        print(f"noise    margin   {sig} sigma (floor {floor}), "
              f"xor errors {xerr}")
        if xerr or not margin_ok(sig, floor):
            margin_fail = 1
            print("NOISE MARGIN REGRESSION — failing red", file=sys.stderr)
        # integer-layer digit margin (the PBS adder sits ~1.5 sigma below
        # the gates; a regression shows here first)
        irec = measure_int_adder_noise(params, args.backend, ek=ek, sk=sk)
        irec["section"] = "noise"
        ifloor = INT_MARGIN_FLOORS.get(params.name)
        irec["margin_floor_sigmas"] = ifloor
        results.append(irec)
        with open(out_path, "a") as f:
            f.write(json.dumps(irec) + "\n")
        isig = irec["next_add_margin_sigmas"]
        print(f"noise    int-add  {isig} sigma (floor {ifloor}), "
              f"digit errors {irec['digit_errors']}")
        # digit_errors tolerance 5: the 4.76-sigma tail (~9e-6/rotation)
        # makes the occasional single error expected at this sample size
        if irec["digit_errors"] > 5 or not margin_ok(isig, ifloor):
            margin_fail = 1
            print("INTEGER NOISE MARGIN REGRESSION — failing red",
                  file=sys.stderr)

    total_err = sum(r.get("errors", 0) for r in results)
    print(f"\n{len(results)} measurements -> {out_path}; "
          f"total errors: {total_err}")
    return 1 if (total_err or margin_fail) else 0


if __name__ == "__main__":
    raise SystemExit(main())
