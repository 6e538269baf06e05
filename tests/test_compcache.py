"""Persistent compile cache placement (utils/compcache.py).

The cache lands in JAX_COMPILATION_CACHE_DIR when that is set, with no
other directory set in code, and otherwise in the fixed <repo>/.jax_cache:
a directory that moved from run to run would never hit.
"""
import os
import subprocess
import sys

from cufhe_jax.utils import compcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KNOBS = ("jax_compilation_cache_dir",
          "jax_persistent_cache_min_entry_size_bytes",
          "jax_persistent_cache_min_compile_time_secs")


def _restore(prev_cfg):
    import jax
    from jax._src import compilation_cache as _cc
    for k, v in prev_cfg.items():
        jax.config.update(k, v)
    # config restore alone is not enough: jax latches module globals on
    # first use, so later compiles in this process would still write into
    # the cache directory this test chose
    _cc.reset_cache()


def _listing(d):
    return set(os.listdir(d)) if os.path.isdir(d) else set()


def test_enable_idempotent_and_functional(monkeypatch):
    import jax
    import numpy as np

    monkeypatch.delenv(compcache.ENV_VAR, raising=False)
    prev_cfg = {k: getattr(jax.config, k) for k in _KNOBS}
    try:
        d1 = compcache.enable()
        d2 = compcache.enable()
        assert d1 == d2 == compcache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == compcache.DEFAULT_DIR
        out = jax.jit(lambda x: x + 1)(np.arange(4))
        assert list(np.asarray(out)) == [1, 2, 3, 4]
    finally:
        _restore(prev_cfg)


def test_env_dir_is_where_the_cache_lands(tmp_path):
    """A fresh process with the variable set writes its compiled program
    there and nowhere else."""
    env_dir = tmp_path / "env_cache"
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import jax, numpy as np\n"
            "from cufhe_jax.utils import compcache\n"
            "d = compcache.enable()\n"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0.0)\n"
            "jax.config.update('jax_persistent_cache_min_entry_size_bytes',"
            " 0)\n"
            "jax.jit(lambda x: x * 3 + 1)(np.arange(7)).block_until_ready()\n"
            "print(d, jax.config.jax_compilation_cache_dir)\n" % REPO)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(env_dir))
    before = _listing(compcache.DEFAULT_DIR)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [str(env_dir), str(env_dir)]
    assert env_dir.is_dir() and os.listdir(env_dir)
    assert _listing(compcache.DEFAULT_DIR) == before


def test_env_dir_is_not_set_in_code(tmp_path, monkeypatch):
    """With the variable set, enable() leaves the directory to JAX: no
    jax.config.update of the cache directory at all."""
    import jax

    monkeypatch.setenv(compcache.ENV_VAR, str(tmp_path / "c"))
    calls = []
    real = jax.config.update
    prev_cfg = {k: getattr(jax.config, k) for k in _KNOBS}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: (calls.append(k), real(k, v)))
    try:
        assert compcache.enable() == str(tmp_path / "c")
        assert compcache.cache_dir() == str(tmp_path / "c")
        assert "jax_compilation_cache_dir" not in calls
        assert jax.config.jax_compilation_cache_dir == \
            prev_cfg["jax_compilation_cache_dir"]
    finally:
        monkeypatch.setattr(jax.config, "update", real)
        _restore(prev_cfg)


def test_default_dir_is_fixed(monkeypatch):
    """Without the variable: <repo>/.jax_cache, the same in every process
    (no pid, no time, no temp dir in the path)."""
    monkeypatch.delenv(compcache.ENV_VAR, raising=False)
    here = compcache.cache_dir()
    assert here == os.path.join(REPO, ".jax_cache")
    assert str(os.getpid()) not in here
    env = {k: v for k, v in os.environ.items() if k != compcache.ENV_VAR}
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, %r)\n"
         "from cufhe_jax.utils import compcache; print(compcache.cache_dir())"
         % REPO], capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == here
