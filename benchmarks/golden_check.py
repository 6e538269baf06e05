"""On-device uint32-exact golden check: the hardware bit-exactness proof.

Runs a few samples of two-input gates + mux at the full parameter set on
whatever device JAX resolves and diffs the output ciphertexts
uint32-for-uint32 against `golden.gate_lvl0` / `golden.mux_lvl0` (the
reference's oracle pattern, test/test_util.h:8-95, strengthened from
decrypt-only to word-exact). chip_smoke.py runs the same check on the GPU.

Prints one JSON line; exit 1 on any mismatched word.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

_MUX = ("mux", "nmux")


def golden_samples(sk, ek, rng, counts: dict) -> dict:
    """Random encrypted inputs and their golden outputs, per op.

    counts maps an op name (a two-input gate, "mux" or "nmux") to its
    sample count. Returns name -> ([in0, in1, sel] stacked ciphertexts,
    golden outputs); computed once, the samples can be diffed against any
    number of device Contexts."""
    from cufhe_jax import golden as G

    out = {}
    for name, nb in counts.items():
        bits = rng.integers(0, 2, (3, nb))
        cts = [np.stack([G.encrypt_bit(int(v), sk, rng) for v in row])
               .astype(np.uint32) for row in bits]
        if name in _MUX:
            want = [G.mux_lvl0(cts[2][i], cts[0][i], cts[1][i], ek,
                               negate=(name == "nmux")) for i in range(nb)]
        else:
            want = [G.gate_lvl0(name, cts[0][i], cts[1][i], ek)
                    for i in range(nb)]
        out[name] = (cts, np.stack(want).astype(np.uint32))
    return out


def device_diff(ctx, samples: dict, pad_to=None) -> dict:
    """Mismatched uint32 words per op between `ctx` and golden `samples`.

    pad_to repeats the sample rows up to that batch, so the check runs the
    very program (same batch shape) that a timed run uses; only the sample
    rows are compared."""
    import jax
    import jax.numpy as jnp

    from cufhe_jax.models.api import Ctxt

    per = {}
    for name, (cts, want) in samples.items():
        nb, width = want.shape
        rows = pad_to or nb
        x = [Ctxt(jnp.asarray(np.resize(c, (rows, width))), 0) for c in cts]
        if name in _MUX:
            dev = ctx.mux(x[2], x[0], x[1], negate=(name == "nmux"))
        else:
            dev = ctx.gate(name, x[0], x[1])
        got = np.asarray(jax.device_get(dev.data))[:nb]
        per[name] = (int(np.sum(got != want)), int(want.size))
    return per


def golden_diff(ctx, sk, ek, rng, nb: int = 8,
                gates=("nand", "xor", "andny"), check_mux: bool = True,
                pad_to=None):
    """uint32 mismatch count between device gates and the golden model.
    Returns (mismatched_words, total_words)."""
    counts = {g: nb for g in gates}
    if check_mux:
        counts["mux"] = nb
    per = device_diff(ctx, golden_samples(sk, ek, rng, counts), pad_to)
    return (sum(m for m, _ in per.values()), sum(t for _, t in per.values()))


def main() -> int:
    import jax

    from _keys import append_result, load_or_make_bench_keys
    from cufhe_jax.models.api import Context

    pname = os.environ.get("GOLDEN_PARAMS", "tfhepp_128bit")
    backend = os.environ.get("GOLDEN_BACKEND", "auto")
    nb = int(os.environ.get("GOLDEN_SAMPLES", "8"))
    sk, ek = load_or_make_bench_keys(pname)
    ctx = Context(ek, backend=backend)
    rng = np.random.default_rng(23)
    mism, total = golden_diff(ctx, sk, ek, rng, nb=nb)
    rec = {"bench": "golden_onchip", "params": pname, "backend": backend,
           "samples": nb, "mismatched_words": mism, "total_words": total,
           "platform": jax.devices()[0].platform,
           "device": jax.devices()[0].device_kind}
    print(json.dumps(rec))
    append_result(rec)
    return 1 if mism else 0


if __name__ == "__main__":
    raise SystemExit(main())
