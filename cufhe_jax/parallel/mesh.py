"""Mesh construction and sharding helpers."""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DATA_AXIS = "data"


def init_distributed(**kwargs) -> None:
    """Multi-host init (jax.distributed). The reference has no multi-node
    support at all (SURVEY.md §5); on a multi-host cluster this one call is the entire
    communication backend setup."""
    jax.distributed.initialize(**kwargs)


def data_mesh(devices: Optional[Sequence] = None,
              n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over all (or the first n) devices: the analogue of
    SetGPUNum(n) (cufhe_gates_gpu.cu:38)."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (DATA_AXIS,))


def shard_spec(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis across the mesh."""
    return NamedSharding(mesh, PartitionSpec(DATA_AXIS))


def replicate_spec(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_batch(x, mesh: Mesh):
    """Place a [B, ...] array with B sharded over the data axis (streams →
    batch-axis mapping; B must be divisible by mesh size)."""
    return jax.device_put(x, shard_spec(mesh))


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (keys) to every device — the multi-GPU key upload
    loop (bootstrap_gpu.cu:115-137, keyswitch_gpu.cu:9-16) as one placement."""
    return jax.device_put(tree, replicate_spec(mesh))


def data_parallel(fn, mesh: Mesh, batch_argnums: Sequence[int]):
    """Wrap `fn` in jax.shard_map over the data axis.

    Args listed in `batch_argnums` have their leading (batch) axis sharded
    across the mesh; every other arg (gate constants, evaluation keys — a
    pytree prefix spec covers DeviceKeys) is replicated. Gate evaluation is
    per-ciphertext independent, so the body needs zero collectives: this is
    the reference's streams-round-robin-over-GPUs model
    (cufhe_gpu.cuh:152-189) as one SPMD program.

    shard_map (not plain jit-with-sharding) keeps the partitioning explicit:
    each device runs the unpartitioned gate program on its batch shard, and
    XLA's partitioner has nothing to decide.
    """
    bset = set(batch_argnums)
    P = PartitionSpec

    def wrapper(*args):
        in_specs = tuple(P(DATA_AXIS) if i in bset else P()
                         for i in range(len(args)))
        # check_vma=False: the integer layer's lax.scan carries start from
        # replicated constants (trivial ciphertexts) and become per-shard
        # inside the body, which the varying-axes check rejects; the
        # replication property is instead proven by the sharded-vs-
        # unsharded bit-equality tests (tests/test_mesh.py).
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=P(DATA_AXIS), check_vma=False)(*args)

    return wrapper
