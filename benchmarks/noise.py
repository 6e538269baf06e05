"""Empirical phase-noise measurement — validates the correctness-noise
claims behind each configuration (docs/DESIGN.md): decrypts gate outputs to
their raw torus phase and reports the noise distribution around ±mu, plus
the implied failure margin in sigmas.

The reference has no noise tooling at all (tests only count wrong bits);
production deployments need the margin, not just pass/fail.

Usage: python benchmarks/noise.py [--batch 2048] [--params tfhepp_128bit]
            [--backend auto]
Prints one JSON line per configuration.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: Documented margin floors per shipping configuration (sigmas of worst-
#: gate decision margin, measured at 6.3 / 5.2; the margins follow from the
#: bit-exact arithmetic, not the device): the suite fails red if a change
#: dips below these — perf work cannot silently trade away correctness
#: margin with a reduced-precision product.
MARGIN_FLOORS = {
    "tfhepp_128bit": 6.0,        # measured 6.3
    "tfhepp_128bit_bg8": 5.0,    # measured 5.2
    "tfhepp_80bit": 12.0,        # measured 18.0 (digit-limb split)
    "cggi19": 10.0,              # measured 14.2
}

#: Integer-layer (PBS adder) digit-margin floors, sigmas of the next-add
#: LUT decision margin (measured 4.76 at msg_bits=1 in round 4, ~9e-6
#: failure tail per rotation). A kernel/schedule change eroding this
#: silently would corrupt encrypted-integer arithmetic long before the
#: gate margins noticed (gates sit at 6.3 sigma).
INT_MARGIN_FLOORS = {
    "tfhepp_128bit": 4.5,        # measured 4.76 (r4), 4.73 (r5, batch 256)
    "radix4_2048": 8.0,          # measured 8.87 (r5; msg_bits=2 digits)
}


def margin_ok(sigmas, floor) -> bool:
    """The red-gate predicate (kept trivial so it is unit-testable:
    tests/test_noise_gate.py feeds it an intentionally-broken config)."""
    return floor is None or sigmas is None or sigmas >= floor


def load_keys(params):
    """Load or create the cached key pair for a preset (stale-fingerprint
    caches regenerate transparently — shared _keys helper)."""
    from _keys import load_or_make_bench_keys
    sk, ek = load_or_make_bench_keys(params.name)
    return ek, sk


def measure_noise(params, backend: str = "auto", batch: int = 2048,
                  ek=None, sk=None) -> dict:
    """Measure gate-output phase noise + worst-gate margin for a preset.
    Returns the JSON record (importable: suite.py uses this as a
    regression gate)."""
    import jax

    from cufhe_jax import golden as G
    from cufhe_jax.models import Context
    from cufhe_jax.models.api import encrypt_bits

    if ek is None or sk is None:
        ek, sk = load_keys(params)
    ctx = Context(ek, backend=backend)
    rng = np.random.default_rng(11)
    B = batch
    bits0 = rng.integers(0, 2, B)
    bits1 = rng.integers(0, 2, B)
    a = encrypt_bits(bits0, sk, rng)
    b = encrypt_bits(bits1, sk, rng)
    out = ctx.nand(a, b)

    def phase_noise(ct_batch, want_bits):
        data = np.asarray(jax.device_get(ct_batch.data))
        mu = params.lvl0.mu
        ph = np.array([G.tlwe_phase(ct, sk.lvl0) for ct in data],
                      dtype=np.uint32).astype(np.int64)
        ph[ph >= 1 << 31] -= 1 << 32               # centered representative
        return ph - np.where(want_bits == 1, mu, -mu)

    mu = params.lvl0.mu
    noise = phase_noise(out, 1 - (bits0 & bits1))
    std = float(noise.std())

    # The operationally binding case: a gate whose BOTH inputs are
    # bootstrapped outputs. XOR doubles the input coefficients, so it has
    # the tightest margin: |2*n0 + 2*n1| must stay under mu.
    outA = ctx.nand(a, b)                          # noise ~std each
    outB = ctx.nand(b, a)
    wantA = 1 - (bits0 & bits1)
    x = ctx.xor(outA, outB)                        # wantA ^ wantA = 0
    xn = phase_noise(x, np.zeros(B, dtype=int))
    x_errors = int(np.sum(np.abs(xn) >= mu))

    return {
        "metric": "gate_output_phase_noise",
        "params": params.name, "backend": backend, "batch": B,
        "noise_std_log2": round(float(np.log2(std)), 2) if std else None,
        "max_abs_noise_log2": round(float(np.log2(np.abs(noise).max())), 2),
        "decrypt_margin_sigmas": round(mu / std, 2) if std else None,
        "worst_gate_margin_sigmas":
            round(mu / (2 * np.sqrt(2) * std), 2) if std else None,
        "xor_of_bootstrapped_errors": x_errors,
        "xor_noise_std_log2": round(float(np.log2(xn.std())), 2),
        "device": str(jax.devices()[0]),
    }


def measure_int_adder_noise(params, backend: str = "auto", batch: int = 256,
                            bits: int = 32, msg_bits: int = 1,
                            ek=None, sk=None) -> dict:
    """Integer-layer digit noise: one fused ripple add, then the phase
    error of every output digit and the implied NEXT-add LUT margin
    (input = three fresh digits + theta=1 mod-switch; models/integers.py
    noise budget). Importable: suite.py gates red on INT_MARGIN_FLOORS."""
    import jax

    from cufhe_jax import golden as G
    from cufhe_jax.models import (Context, IntCodec, IntContext,
                                  encrypt_uint)

    if ek is None or sk is None:
        ek, sk = load_keys(params)
    codec = IntCodec(msg_bits=msg_bits)
    ictx = IntContext(Context(ek, backend=backend), codec)
    rng = np.random.default_rng(19)
    mod = 1 << bits
    D = codec.digits_for(bits)
    m = codec.msg_bits
    xs = [int(v) for v in rng.integers(0, mod, batch, dtype=np.uint64)]
    ys = [int(v) for v in rng.integers(0, mod, batch, dtype=np.uint64)]
    s = ictx.add(encrypt_uint(xs, bits, sk, codec, rng=rng),
                 encrypt_uint(ys, bits, sk, codec, rng=rng))
    data = np.asarray(jax.device_get(s.digits))
    want = [(a + b) % mod for a, b in zip(xs, ys)]
    errs, bad = [], 0
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
    lp = params.lvl1
    ms_var = params.lvl0.dim / 2 * (1 << (32 - lp.nbit)) ** 2 / 12
    sigma_in = float(np.sqrt(3 * std ** 2 + ms_var))
    margin = (codec.delta / 2) / sigma_in if sigma_in else float("inf")
    return {
        "metric": "int_adder_digit_noise",
        "params": params.name, "backend": backend, "batch": batch,
        "bits": bits, "msg_bits": m,
        "digit_noise_std_log2": round(float(np.log2(std)), 2) if std else None,
        "digit_errors": bad,
        "next_add_margin_sigmas": round(margin, 2),
        "device": str(jax.devices()[0]),
    }


def measure_cmux_tree_noise(params, backend: str = "auto", depth: int = 8,
                            batch: int = 64, ek=None, sk=None) -> list:
    """CMUX-chain noise growth: how deep a vertical-packing tree can go.

    Each tree level adds one external product of noise to the selected
    word (no bootstrap in the tree), so depth is budgeted against the
    TRLWE decryption margin. Chains `depth` CMUX levels (one shared TRGSW
    selector per level, as in a real tree) over a batch of N-slot words
    and reports the slot-phase noise and margin after every level.
    Returns one record per depth.
    """
    import jax

    from cufhe_jax import golden as G
    from cufhe_jax.models import Context
    from cufhe_jax.models.api import TrlweCtxt

    if ek is None or sk is None:
        ek, sk = load_keys(params)
    ctx = Context(ek, backend=backend)
    lp = params.lvl1
    mu = lp.mu
    rng = np.random.default_rng(13)

    def enc_words(bits):
        return np.stack([G.trlwe_encrypt_bits(w, lp, sk.lvl1, rng)
                         for w in bits])

    plain = rng.integers(0, 2, (batch, lp.n))
    cur = TrlweCtxt(np.asarray(enc_words(plain)))
    rows = []
    for d in range(1, depth + 1):
        alt_plain = rng.integers(0, 2, (batch, lp.n))
        alt = TrlweCtxt(np.asarray(enc_words(alt_plain)))
        sel = int(rng.integers(2))
        tg = ctx.prepare_trgsw(G.trgsw_encrypt(sel, lp, sk.lvl1, rng))
        # selected branch carries the accumulated chain; the other is fresh
        cur = (ctx.cmux(tg, cur, alt) if sel == 1
               else ctx.cmux(tg, alt, cur))
        data = np.asarray(jax.device_get(cur.data))
        ph = np.stack([G.trlwe_phase(w, lp, sk.lvl1)
                       for w in data]).astype(np.int64)
        ph[ph >= 1 << 31] -= 1 << 32
        noise = ph - np.where(plain == 1, mu, -mu)
        std = float(noise.std())
        rows.append({
            "metric": "cmux_tree_noise",
            "params": params.name, "backend": backend,
            "depth": d, "words": batch,
            "noise_std_log2": round(float(np.log2(std)), 2) if std else None,
            "max_abs_noise_log2":
                round(float(np.log2(max(np.abs(noise).max(), 1))), 2),
            "margin_sigmas": round(mu / std, 2) if std else None,
            "slot_errors": int(np.sum(np.abs(noise) >= mu)),
            "device": str(jax.devices()[0]),
        })
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--params", default="tfhepp_128bit")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--cmux-depth", type=int, default=0,
                    help="also measure CMUX-tree noise to this depth")
    args = ap.parse_args()
    from cufhe_jax import PRESETS
    print(json.dumps(measure_noise(PRESETS[args.params], args.backend,
                                   args.batch)))
    if args.cmux_depth:
        for row in measure_cmux_tree_noise(PRESETS[args.params],
                                           args.backend, args.cmux_depth):
            print(json.dumps(row))


if __name__ == "__main__":
    main()
