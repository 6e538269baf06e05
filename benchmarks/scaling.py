"""Multi-device correctness sweep (the test_gate_gpu_multi.cc analogue).

On a virtual CPU mesh, the sharded gate program (shard_map over a
1/2/4/8-device mesh, resolved "auto" backend) is bit-identical to the
unsharded program at every device count, and its compiled HLO contains
zero collective ops: per-device work is independent, so cross-device
scaling is bounded only by host feeding, not by communication. The result
is stored as a JSON line in benchmarks/results.jsonl.

The same property on real cards, with the timing of one card against
several, is `python3 chip_smoke.py --devices 4`.

Run: python benchmarks/scaling.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

COLLECTIVES = ("all-reduce", "all-gather", "all-to-all", "collective-permute",
               "reduce-scatter")
RESULTS = os.path.join(REPO, "benchmarks", "results.jsonl")


def log(rec: dict) -> None:
    rec = {"bench": "scaling", **rec}
    print(json.dumps(rec))
    with open(RESULTS, "a") as f:
        f.write(json.dumps(rec) + "\n")


def cpu_mesh_sweep() -> None:
    """Sharded == unsharded at 1,2,4,8 devices; zero collectives in HLO."""
    env = os.environ.copy()
    code = r"""
import os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
import jax
jax.config.update("jax_platforms", "cpu")
import json
import numpy as np
from cufhe_jax import golden as G
from cufhe_jax import params as P
from cufhe_jax.ops import bootstrap as B, keys as K
from cufhe_jax.parallel.mesh import data_mesh, data_parallel
from jax.sharding import NamedSharding, PartitionSpec

params = P.TINY_N128
sk = G.keygen(params, seed=21)
ek = G.make_eval_key(sk, seed=22)
keys = K.prepare_keys(ek, backends=(B.resolve_backend("auto", params),))
rng = np.random.default_rng(23)
Bn = 16
mk = lambda: np.stack([G.encrypt_bit(int(v), sk, rng)
                       for v in rng.integers(0, 2, Bn)])
a_np, b_np = mk(), mk()
fn = lambda x, y, k: B.gate_lvl0(G.GATE_CONSTANTS["nand"], x, y, k, params)
ref = np.asarray(jax.jit(fn)(a_np, b_np, keys))
out = []
for nd in (1, 2, 4, 8):
    mesh = data_mesh(n_devices=nd)
    repl = NamedSharding(mesh, PartitionSpec())
    shard = NamedSharding(mesh, PartitionSpec("data"))
    kd = jax.device_put(keys, repl)
    a = jax.device_put(a_np, shard)
    b = jax.device_put(b_np, shard)
    prog = jax.jit(data_parallel(fn, mesh, (0, 1)))
    got = prog(a, b, kd)
    hlo = prog.lower(a, b, kd).compile().as_text()
    colls = [c for c in %r if c in hlo]
    out.append({"devices": nd,
                "bit_exact": bool(np.array_equal(np.asarray(got), ref)),
                "collectives": colls,
                "out_devices": len(got.sharding.device_set)})
print("RESULT " + json.dumps(out))
""" % (COLLECTIVES,)
    import subprocess
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=900)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    if not line:
        print(r.stdout, r.stderr, file=sys.stderr)
        raise RuntimeError("cpu mesh sweep failed")
    rows = json.loads(line[0][len("RESULT "):])
    ok = all(row["bit_exact"] and not row["collectives"] and
             row["out_devices"] == row["devices"] for row in rows)
    log({"metric": "cpu_mesh_sweep", "rows": rows, "pass": ok})
    if not ok:
        raise SystemExit("cpu mesh sweep FAILED: " + json.dumps(rows))


if __name__ == "__main__":
    cpu_mesh_sweep()
