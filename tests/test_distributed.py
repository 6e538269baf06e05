"""Multi-process distributed gate evaluation (the multi-host story).

The reference tops out at 2 GPUs in ONE process with replicated keys
(test_gate_gpu_multi.cc:36-85); the JAX equivalent is multiple
host processes forming one global device mesh via jax.distributed
(SURVEY.md §5 "distributed communication backend"). This spawns two real
processes, each owning 4 CPU devices of an 8-device global mesh, and has
each verify its local shard of a shard_map'd NAND batch bit-exactly
against the golden model — keys replicated, batch sharded, zero
collectives in the gate program.
"""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_dist_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(coord):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, "2", str(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for pr in procs:
            pr.kill()
        return False, "timed out:\n" + "\n".join(o or "" for o in outs)
    for pid, (pr, out) in enumerate(zip(procs, outs)):
        if pr.returncode != 0 or f"DIST_OK pid={pid}" not in out:
            return False, f"pid {pid} failed:\n{out[-2000:]}"
    return True, ""


def test_two_process_distributed_nand():
    # the free-port probe has an inherent close-then-rebind race (another
    # process can claim the port before worker 0's coordinator binds it),
    # so one retry with a fresh port de-flakes it
    ok, msg = _run_workers(f"127.0.0.1:{_free_port()}")
    if not ok:
        ok, msg = _run_workers(f"127.0.0.1:{_free_port()}")
    assert ok, msg
