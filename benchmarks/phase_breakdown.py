"""Phase breakdown of one NAND gate bootstrap at the headline config:
times (a) the full gate, (b) blind rotation alone, (c) extract+keyswitch
alone, (d) the KS one-hot decompose alone — each as its own jitted program
at the same batch on the resolved ("auto") backend, medians of reps, every
timing ended by block_until_ready. Needs a GPU; exits non-zero without one.

Usage: python benchmarks/phase_breakdown.py [batch]
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


def timed(fn, *args, reps=5):
    """Median seconds of fn(*args), after one compile/warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"phase_breakdown: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    from _keys import load_or_make_bench_keys
    from cufhe_jax import TFHEPP_128
    from cufhe_jax.golden import GATE_CONSTANTS
    from cufhe_jax.ops import bootstrap as B
    from cufhe_jax.ops.keys import prepare_keys
    from cufhe_jax.ops.keyswitch import key_switch, ks_decompose_coeffs

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    params = TFHEPP_128
    _, ek = load_or_make_bench_keys(params.name)
    backend = B.resolve_backend("auto", params)
    keys = prepare_keys(ek, backends=(backend,))

    rng = np.random.default_rng(3)
    n0 = params.lvl0.dim
    mk = lambda: jnp.asarray(rng.integers(0, 1 << 32, size=(batch, n0 + 1),
                                          dtype=np.uint64).astype(np.uint32))
    in0, in1 = mk(), mk()

    nand = jax.jit(lambda a, b, k: B.gate_lvl0(
        GATE_CONSTANTS["nand"], a, b, k, params))

    @jax.jit
    def br_only(a, b, k):
        ca, cb, off = B._gate_coeffs(GATE_CONSTANTS["nand"], params.lvl0.mu)
        aa, bb = B._pre_add(a, b, ca, cb, off, n0)
        return B.blind_rotate(aa, bb, params.lvl1.mu, k, params)

    @jax.jit
    def ks_only(acc, k):
        tlwe1 = B.sample_extract_for_ks(acc, params.lvl1)
        return key_switch(tlwe1, k.ksk_limbs_sei, params)

    @jax.jit
    def dec_only(tlwe1):
        return ks_decompose_coeffs(tlwe1[:, :params.lvl1.k * params.lvl1.n],
                                   params)

    acc = jax.block_until_ready(br_only(in0, in1, keys))
    tlwe1 = jax.block_until_ready(B.sample_extract_for_ks(acc, params.lvl1))

    print(json.dumps({
        "batch": batch,
        "backend": backend,
        "full_nand_ms": timed(nand, in0, in1, keys) * 1e3,
        "blind_rotate_ms": timed(br_only, in0, in1, keys) * 1e3,
        "extract_ks_ms": timed(ks_only, acc, keys) * 1e3,
        "ks_decompose_ms": timed(dec_only, tlwe1) * 1e3,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
