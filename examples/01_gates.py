"""Quickstart: encrypt bits, evaluate gates homomorphically, decrypt.

The cufhe_jax flow mirrors the reference's (keygen -> Initialize(ek) ->
gates -> decrypt, cuFHE README.md "Usage"), with two differences that are
the JAX design: ciphertexts are *batches* (the batch axis is the
parallelism — the analogue of the reference's streams x GPUs), and
everything stays device-resident between gates (the reference's
`g`-variants as the default).

Run:  python examples/01_gates.py             # TINY params, < 10 s on CPU
      python examples/01_gates.py --full      # TFHEpp 128-bit (GPU: ~s,
                                              #   CPU: minutes + keygen)
"""
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

if "--full" not in sys.argv:
    # TINY demo runs on CPU
    import jax
    jax.config.update("jax_platforms", "cpu")

from cufhe_jax import TFHEPP_128, TINY, golden as G
from cufhe_jax.models import Context, decrypt_bits, encrypt_bits

params = TFHEPP_128 if "--full" in sys.argv else TINY
rng = np.random.default_rng(42)

# --- client side: secret key + evaluation key -----------------------------
t0 = time.time()
sk = G.keygen(params, seed=1)          # secret key (client keeps this)
ek = G.make_eval_key(sk, seed=2)       # evaluation key (server gets this)
print(f"keygen: {time.time() - t0:.1f}s ({params.name})")

# --- server side: one-time context setup (Initialize(ek) analogue) --------
ctx = Context(ek)

# --- encrypt a batch of bits ----------------------------------------------
batch = 64
bits_a = rng.integers(0, 2, batch)
bits_b = rng.integers(0, 2, batch)
ct_a = encrypt_bits(bits_a, sk, rng)
ct_b = encrypt_bits(bits_b, sk, rng)

# --- homomorphic evaluation (server never sees plaintext) -----------------
t0 = time.time()
ct_nand = ctx.nand(ct_a, ct_b)
ct_xor = ctx.gate("xor", ct_a, ct_b)
ct_chain = ctx.nand(ct_nand, ct_xor)      # gates chain device-resident
print(f"3 batched gates ({3 * batch} bootstraps): {time.time() - t0:.1f}s")

# --- decrypt and verify ----------------------------------------------------
want_nand = 1 - (bits_a & bits_b)
want_xor = bits_a ^ bits_b
want_chain = 1 - (want_nand & want_xor)
assert np.array_equal(decrypt_bits(ct_nand, sk), want_nand)
assert np.array_equal(decrypt_bits(ct_xor, sk), want_xor)
assert np.array_equal(decrypt_bits(ct_chain, sk), want_chain)
print(f"all {3 * batch} decryptions correct")
