"""Encrypted-integer benchmark: radix adds via multi-output PBS.

Measures, at a production parameter set on the GPU:
  * fused ripple-add throughput (word adds/s and blind rotations/s — the
    rotation rate should track the headline gate rate, since a full adder
    is ONE rotation per digit),
  * empirical digit noise and the implied LUT decision margin (the
    integer-layer analogue of benchmarks/noise.py),
  * a chained-add error count (every digit of every chained result
    verified against the plaintext model).

Usage: python benchmarks/integers.py [--bits 32] [--batch 256] [--chain 4]
            [--params tfhepp_128bit] [--msg-bits 1] [--backend auto]
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

def _force(x):
    import jax
    return np.asarray(jax.device_get(x))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=32)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chain", type=int, default=4)
    ap.add_argument("--params", default="tfhepp_128bit")
    ap.add_argument("--msg-bits", type=int, default=1)
    ap.add_argument("--buf-bits", type=int, default=None,
                    help="carry-buffer bits (default msg_bits+1; the "
                         "multiplier at msg_bits>=2 needs 2*msg_bits)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--mul-bits", type=int, default=0,
                    help="also bench the fused multiplier at this width "
                         "(0 = skip; products are verified)")
    ap.add_argument("--div-bits", type=int, default=0,
                    help="also bench fused restoring divmod at this width "
                         "(0 = skip; quotients/remainders are verified)")
    args = ap.parse_args()
    if (args.mul_bits and args.msg_bits >= 2
            and (args.buf_bits or args.msg_bits + 1) < 2 * args.msg_bits):
        ap.error(f"--mul-bits at --msg-bits {args.msg_bits} needs "
                 f"--buf-bits >= {2 * args.msg_bits} (bivariate "
                 "digit-product phase space)")

    import jax

    from _keys import load_or_make_bench_keys
    from cufhe_jax import PRESETS
    from cufhe_jax import golden as G
    from cufhe_jax.models import (Context, IntCodec, IntContext,
                                  decrypt_uint, encrypt_uint)

    params = PRESETS[args.params]
    sk, ek = load_or_make_bench_keys(params.name)
    codec = IntCodec(msg_bits=args.msg_bits, buf_bits=args.buf_bits)
    ictx = IntContext(Context(ek, backend=args.backend), codec)

    rng = np.random.default_rng(17)
    B, bits = args.batch, args.bits
    D = codec.digits_for(bits)
    mod = 1 << bits
    xs = [int(v) for v in rng.integers(0, mod, B, dtype=np.uint64)]
    ys = [int(v) for v in rng.integers(0, mod, B, dtype=np.uint64)]
    x = encrypt_uint(xs, bits, sk, codec, rng=rng)
    y = encrypt_uint(ys, bits, sk, codec, rng=rng)

    # -- throughput: fused ripple add (one dispatch) ---------------------
    # Completion barrier = forcing the LAST digit only ([B, n0+1], the same
    # ~2.6 MB readback the gate bench pays): it depends on the whole carry
    # chain, and the dispatch that produced it materializes every digit
    # before the slice program runs. Forcing the full [B, D, n0+1] result
    # instead would bill the measurement for a device-to-host copy of the
    # whole result, which the reference's own methodology (cudaEvents,
    # device-resident ciphertexts) also excludes.
    s = ictx.add(x, y)                      # compile + warm
    _force(s.digits[:, -1])
    reps = 3
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        s = ictx.add(x, y)
        _force(s.digits[:, -1])
        ts.append(time.perf_counter() - t0)
    dt = sorted(ts)[len(ts) // 2]
    adds_per_s = B / dt
    rot_per_s = B * D / dt

    # -- noise: output digit phase errors + implied next-add margin ------
    data = _force(s.digits)
    want = [(a + b) % mod for a, b in zip(xs, ys)]
    m = codec.msg_bits
    errs = []
    bad = 0
    for i, row in enumerate(data):
        for dgt in range(D):
            ph = int(G.tlwe_phase(row[dgt], sk.lvl0))
            wv = (want[i] >> (m * dgt)) & (codec.base - 1)
            diff = (ph - wv * codec.delta) % (1 << 32)
            if diff >= 1 << 31:
                diff -= 1 << 32
            errs.append(diff)
            got_v = int(round(ph / codec.delta)) % (1 << (codec.buf_bits + 1))
            bad += int((got_v & (codec.base - 1)) != wv)
    std = float(np.std(errs))
    # next-add input = sum of three fresh digits + theta=1 modswitch
    lp = params.lvl1
    ms_var = params.lvl0.dim / 2 * (1 << (32 - lp.nbit)) ** 2 / 12
    sigma_in = float(np.sqrt(3 * std ** 2 + ms_var))
    margin = (codec.delta / 2) / sigma_in if sigma_in else float("inf")

    # -- chained adds: every digit verified ------------------------------
    acc_plain = list(xs)
    acc = x
    chain_bad = 0
    for c in range(args.chain):
        acc = ictx.add(acc, y)
        acc_plain = [(a + b) % mod for a, b in zip(acc_plain, ys)]
    got = decrypt_uint(acc, sk)
    chain_bad = sum(g != w for g, w in zip(got, acc_plain))

    mul_stats = {}
    if args.mul_bits:
        mb = args.mul_bits
        mxs = [int(v) for v in rng.integers(0, 1 << mb, B, dtype=np.uint64)]
        mys = [int(v) for v in rng.integers(0, 1 << mb, B, dtype=np.uint64)]
        mx = encrypt_uint(mxs, mb, sk, codec, rng=rng)
        my = encrypt_uint(mys, mb, sk, codec, rng=rng)
        prod = ictx.mul(mx, my)                 # compile + warm
        _force(prod.digits[:, -1])
        t0 = time.perf_counter()
        prod = ictx.mul(mx, my)
        _force(prod.digits[:, -1])              # thin completion barrier
        mdt = time.perf_counter() - t0
        got = decrypt_uint(prod, sk)
        mul_stats = {
            "mul_bits": mb,
            "muls_per_sec": round(B / mdt, 1),
            "ms_per_mul_batch": round(mdt * 1e3, 1),
            "mul_rotations_per_sec":
                round(3 * (mb // codec.msg_bits) ** 2 * B / mdt, 1),
            "mul_word_errors":
                sum(g != a * b for g, a, b in zip(got, mxs, mys)),
        }

    div_stats = {}
    if args.div_bits:
        # Segment wide divides into ~8-bit dispatches: one 32-bit divide
        # is ~3,100 sequential latency-bound rotations in one execution
        # otherwise (see divmod_ docstring). Bit-exact either way.
        os.environ.setdefault("CUFHE_DIV_SEG", "8")
        db = args.div_bits
        Dd = db // codec.msg_bits
        dxs = [int(v) for v in rng.integers(0, 1 << db, B, dtype=np.uint64)]
        dys = [int(v) for v in rng.integers(1, 1 << db, B, dtype=np.uint64)]
        dx = encrypt_uint(dxs, db, sk, codec, rng=rng)
        dy = encrypt_uint(dys, db, sk, codec, rng=rng)
        q, r = ictx.divmod_(dx, dy)             # compile + warm
        _force(q.digits[:, -1])
        t0 = time.perf_counter()
        q, r = ictx.divmod_(dx, dy)
        _force(q.digits[:, -1])                 # thin completion barrier
        ddt = time.perf_counter() - t0
        gq, gr = decrypt_uint(q, sk), decrypt_uint(r, sk)
        # division digit margin: the trial-sub inputs (select-output
        # remainder + comp(y) + carry) are noisier than the adder's
        # (ADVICE r4) — measure the OUTPUT digit noise of q and r directly
        derrs = []
        for ic, want_vals in ((q, [a // b for a, b in zip(dxs, dys)]),
                              (r, [a % b for a, b in zip(dxs, dys)])):
            ddata = _force(ic.digits)
            for i, row in enumerate(ddata):
                for dgt in range(row.shape[0]):
                    ph = int(G.tlwe_phase(row[dgt], sk.lvl0))
                    wv = ((want_vals[i] >> (codec.msg_bits * dgt))
                          & (codec.base - 1))
                    diff = (ph - wv * codec.delta) % (1 << 32)
                    derrs.append(diff - (1 << 32) if diff >= 1 << 31
                                 else diff)
        dstd = float(np.std(derrs))
        # next-op margin if a div output digit feeds an adder input
        lp = params.lvl1
        dms_var = params.lvl0.dim / 2 * (1 << (32 - lp.nbit)) ** 2 / 12
        dsig_in = float(np.sqrt(3 * dstd ** 2 + dms_var))
        # per quotient digit: (base-1) trial subs + base-way select over
        # W=(D+1) digits (m=1: 3*D*(D+1))
        div_rots = (2 * codec.base - 1) * Dd * (Dd + 1)
        div_stats = {
            "div_bits": db,
            "divs_per_sec": round(B / ddt, 1),
            "ms_per_div_batch": round(ddt * 1e3, 1),
            "div_rotations_per_sec": round(div_rots * B / ddt, 1),
            "div_digit_noise_std_log2":
                round(float(np.log2(dstd)), 2) if dstd else None,
            "div_next_add_margin_sigmas":
                round((codec.delta / 2) / dsig_in, 2) if dsig_in else None,
            "div_word_errors":
                sum(int(g != a // b) + int(h != a % b)
                    for g, h, a, b in zip(gq, gr, dxs, dys)),
        }

    print(json.dumps({
        "metric": "encrypted_uint_add",
        "params": params.name, "backend": args.backend,
        "msg_bits": m, "bits": bits, "batch": B,
        "adds_per_sec": round(adds_per_s, 1),
        "rotations_per_sec": round(rot_per_s, 1),
        "ms_per_add_batch": round(dt * 1e3, 1),
        "digit_noise_std_log2": round(float(np.log2(std)), 2) if std else None,
        "digit_errors": bad,
        "next_add_margin_sigmas": round(margin, 2),
        "chain_depth": args.chain,
        "chain_word_errors": chain_bad,
        **mul_stats,
        **div_stats,
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
