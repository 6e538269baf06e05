"""Test configuration: run on a virtual 8-device CPU mesh.

Mirrors the task requirement: multi-chip sharding is validated on
`--xla_force_host_platform_device_count=8` CPU devices so single-chip CI and
multi-host runs share code (SURVEY.md §4 note).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Some environments import jax at interpreter startup (before conftest), so
# the env vars alone are too late; force the platform programmatically too.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cufhe_jax import golden as G  # noqa: E402
from cufhe_jax import params as P  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips where none is present "
        "(python -m pytest tests/ -m gpu)")


@pytest.fixture(scope="session")
def tiny_key():
    sk = G.keygen(P.TINY, seed=0)
    ek = G.make_eval_key(sk, seed=1)
    return sk, ek


@pytest.fixture(scope="session")
def tiny_k2_key():
    sk = G.keygen(P.TINY_K2, seed=2)
    ek = G.make_eval_key(sk, seed=3)
    return sk, ek


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
