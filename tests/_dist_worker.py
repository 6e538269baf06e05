"""Worker process for the multi-process distributed test.

Run as: python tests/_dist_worker.py <coordinator> <num_procs> <pid>

Each process owns 4 CPU devices of an 8-device global mesh, builds the
same keys from a fixed seed (keys are replicated state, exactly like the
reference's per-GPU key upload, bootstrap_gpu.cu:115-137), feeds its local
shard of a global ciphertext batch, runs the shard_map'd gate program, and
verifies its local output rows against the golden model. No collectives
are needed by the gate path, so the only cross-process interaction is
jax.distributed device enumeration — the multi-host topology in miniature.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nproc, process_id=pid)
    assert len(jax.devices()) == 4 * nproc, jax.devices()
    assert len(jax.local_devices()) == 4

    import numpy as np

    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, REPO)
    from cufhe_jax import golden as G
    from cufhe_jax import params as P
    from cufhe_jax.ops import bootstrap as B
    from cufhe_jax.ops import keys as K
    from cufhe_jax.parallel import mesh as M

    p = P.TINY
    sk = G.keygen(p, seed=7)
    ek = G.make_eval_key(sk, seed=8)
    keys = K.prepare_keys(ek, backends=("conv",))

    rng = np.random.default_rng(9)          # same stream on every process
    Bn = 16
    bits0 = rng.integers(2, size=Bn)
    bits1 = rng.integers(2, size=Bn)
    c0 = G.encrypt_bit_batch(bits0, sk, rng)
    c1 = G.encrypt_bit_batch(bits1, sk, rng)

    mesh = M.data_mesh()
    spec = M.shard_spec(mesh)
    rows = Bn // nproc

    def local(x):
        # feed only this process's rows — the multi-host input path
        return jax.make_array_from_process_local_data(
            spec, x[pid * rows:(pid + 1) * rows])

    gate = M.data_parallel(
        lambda a, b, k: B.gate_lvl0(G.GATE_CONSTANTS["nand"], a, b, k, p,
                                    backend="conv"),
        mesh, batch_argnums=(0, 1))
    out = gate(local(c0), local(c1), M.replicate(keys, mesh))

    want = np.stack([G.gate_lvl0("nand", a, b, ek)
                     for a, b in zip(c0, c1)])
    for shard in out.addressable_shards:
        lo = shard.index[0].start or 0
        got = np.asarray(shard.data)
        assert np.array_equal(got, want[lo:lo + got.shape[0]]), \
            f"pid {pid} shard at {lo} mismatches golden"
    print(f"DIST_OK pid={pid} devices={len(jax.devices())}", flush=True)


if __name__ == "__main__":
    main()
