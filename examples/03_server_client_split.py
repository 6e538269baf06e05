"""Server/client key separation with serialization and mesh scale-out.

The deployment model: the client generates keys and encrypts; the server
holds ONLY the evaluation key (never the secret key), evaluates gates over
a device mesh, and returns ciphertexts. The reference bundles cereal for
this but never wires it up; here it is a tested first-class flow.

Run:  python examples/03_server_client_split.py   # TINY params, CPU
"""
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

# simulate a multi-device deployment on CPU (remove these lines on a real
# multi-GPU host — jax.devices() is the mesh)
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
import jax

jax.config.update("jax_platforms", "cpu")
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from cufhe_jax import TINY, golden as G
from cufhe_jax.models import Context, Ctxt, decrypt_bits, encrypt_bits
from cufhe_jax.utils import serialization as S

workdir = tempfile.mkdtemp()
rng = np.random.default_rng(11)

# --- client: keygen, persist, encrypt -------------------------------------
sk = G.keygen(TINY, seed=1)
ek = G.make_eval_key(sk, seed=2)
S.save_secret_key(f"{workdir}/secret.npz", sk)    # stays with the client
S.save_eval_key(f"{workdir}/eval.npz", ek)        # shipped to the server

bits_a = rng.integers(0, 2, 32)
bits_b = rng.integers(0, 2, 32)
ct_a = encrypt_bits(bits_a, sk, rng)
ct_b = encrypt_bits(bits_b, sk, rng)
S.save_ciphertexts(f"{workdir}/inputs_a.npz", np.asarray(ct_a.data),
                   ct_a.level)
S.save_ciphertexts(f"{workdir}/inputs_b.npz", np.asarray(ct_b.data),
                   ct_b.level)

# --- server: no secret key anywhere ---------------------------------------
server_ek = S.load_eval_key(f"{workdir}/eval.npz")
devs = jax.devices()
mesh = Mesh(np.array(devs), ("data",))
ctx = Context(server_ek, mesh=mesh)               # keys replicate, batch shards

da, la = S.load_ciphertexts(f"{workdir}/inputs_a.npz")
db, lb = S.load_ciphertexts(f"{workdir}/inputs_b.npz")
shard = NamedSharding(mesh, PartitionSpec("data"))
in_a = Ctxt(jax.device_put(da, shard), la)
in_b = Ctxt(jax.device_put(db, shard), lb)

out = ctx.nand(in_a, in_b)                        # gate eval: 0 collectives
S.save_ciphertexts(f"{workdir}/result.npz", np.asarray(out.data), out.level)
print(f"server: NAND over {len(devs)}-device mesh, "
      f"output sharding {out.data.sharding.spec}")

# --- client: decrypt the returned result ----------------------------------
client_sk = S.load_secret_key(f"{workdir}/secret.npz")
dr, lr = S.load_ciphertexts(f"{workdir}/result.npz")
got = decrypt_bits(Ctxt(np.asarray(dr), lr), client_sk)
assert np.array_equal(got, 1 - (bits_a & bits_b))
print("client: all decryptions correct")
