"""Scale-out: device meshes, key replication, batch sharding.

The reference's multi-GPU story is full replication of keys + round-robin
streams (SetGPUNum / Stream, cufhe_gpu.cuh:76-95,152-189). The JAX
equivalent: one jax.sharding.Mesh over all devices/hosts, keys replicated,
the ciphertext batch sharded on a "data" axis. Gate evaluation needs zero
collectives (SURVEY.md §2 parallelism table).
"""
from .mesh import (data_mesh, init_distributed, replicate, shard_batch,
                   shard_spec)  # noqa: F401
