"""CPU checks of the GPU entry points (chip_smoke.py, bench.py), the trace
reduction they use, and the on-card golden check behind the `gpu` marker.

`python -m pytest tests/ -m gpu` runs the marked test; it skips wherever
no GPU is present.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))


def _run_cpu(script, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(tmp_path))
    return subprocess.run([sys.executable, os.path.join(REPO, script)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(tmp_path))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script, tmp_path):
    """No CPU fallback: without a GPU nothing runs and no result prints."""
    r = _run_cpu(script, tmp_path)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert r.stdout.strip() == ""


def test_contract_line_is_exact():
    sys.path.insert(0, REPO)
    import chip_smoke
    line = chip_smoke.contract_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in chip_smoke.contract_line("gpu", "x", 4)


def test_trace_summary_on_a_recorded_trace(tmp_path):
    """The busy/idle reduction, checked on a small CPU trace (the host
    plane stands in for the device plane) and on synthetic intervals."""
    import jax
    import jax.numpy as jnp
    import trace_summary as T

    ev = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 30.0, 40.0)]
    s = T.summarize(ev)
    assert s["events"] == 3 and s["gaps"] == 1
    assert s["busy_ms"] == pytest.approx(30e-6)
    assert s["window_ms"] == pytest.approx(40e-6)
    assert s["idle_share"] == pytest.approx(0.25)
    assert s["top_kernels_ms"][0] == ("k1", pytest.approx(20e-6))
    assert T.summarize([]) == {"events": 0}

    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    path = T.newest_xplane(str(tmp_path))
    host = T.summarize(T.device_events(path, "/host:CPU"))
    assert host["events"] > 0 and 0.0 <= host["idle_share"] < 1.0
    assert T.device_events(path) == []      # no GPU plane on the CPU


@pytest.fixture(scope="session")
def gpu():
    """Skip unless JAX, left to its default platform, finds a GPU. The
    tests themselves are pinned to the CPU (conftest), so the check and the
    marked tests run in child processes."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, timeout=300, env=env)
    if r.returncode != 0 or r.stdout.strip() != "gpu":
        pytest.skip("needs a GPU")
    return env


@pytest.mark.gpu
def test_gpu_gates_match_golden_u32(gpu):
    """uint32 bit-exactness on the card at the 128-bit set (the check
    chip_smoke.py's golden phase runs)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "golden_check.py")],
        capture_output=True, text=True, timeout=1800, cwd=REPO,
        env=dict(gpu, GOLDEN_SAMPLES="2"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["mismatched_words"] == 0
    assert rec["platform"] == "gpu"
