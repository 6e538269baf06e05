"""Shared benchmark helpers: cached key material and results logging."""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "benchmarks", "results.jsonl")

if REPO not in sys.path:
    sys.path.insert(0, REPO)


def enable_compile_cache() -> str:
    """Persistent compilation cache for the benches (utils/compcache.py):
    the workload benches carry one-time XLA compiles that should not be
    repaid. Called from load_or_make_bench_keys — i.e. when a bench
    actually RUNS — rather than at import: the unit-test session imports
    bench modules for their tables/flows, and globally enabling the cache
    there would make jax serialize every CPU test executable."""
    from cufhe_jax.utils import compcache
    return compcache.enable()


def load_or_make_bench_keys(pname: str):
    """(sk, ek) for a preset, from the gitignored .bench_keys_* caches
    (regenerate when absent — presets with different gadget parameters
    need their own keys, see CLAUDE.md). Also enables the persistent
    compilation cache: every caller is a bench about to compile."""
    enable_compile_cache()
    from cufhe_jax import PRESETS, golden as G
    from cufhe_jax.utils import serialization as S

    cache = os.path.join(REPO, ".bench_keys_128.npz"
                         if pname == "tfhepp_128bit"
                         else f".bench_keys_{pname}.npz")
    sk_cache = cache.replace("keys", "sk")
    if os.path.exists(cache) and os.path.exists(sk_cache):
        try:
            return S.load_secret_key(sk_cache), S.load_eval_key(cache)
        except ValueError as e:   # params-fingerprint mismatch: regenerate
            print(f"stale key cache ({e}); regenerating", file=sys.stderr)
    print("generating keys...", file=sys.stderr)
    sk = G.keygen(PRESETS[pname], seed=0)
    ek = G.make_eval_key(sk, seed=1)
    S.save_eval_key(cache, ek)
    S.save_secret_key(sk_cache, sk)
    return sk, ek


def append_result(rec: dict) -> None:
    with open(RESULTS, "a") as f:
        f.write(json.dumps(rec) + "\n")
