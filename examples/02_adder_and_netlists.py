"""Encrypted arithmetic two ways: composed gate circuits and compiled
Bristol netlists through the native scheduler.

Way 1 — `models.circuits`: host-side composition of batched gate programs
(the reference's intended kvsp use-case, chaining g-gates on streams).

Way 2 — `runtime`: import a Bristol Fashion netlist, let the C++ scheduler
levelize it, and execute whole levels as single fused programs (all ten
two-input gate types of a level run as ONE compiled program via per-row
gate constants).

Run:  python examples/02_adder_and_netlists.py     # TINY params, CPU-fast
"""
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

jax.config.update("jax_platforms", "cpu")   # TINY demo: CPU is plenty

from cufhe_jax import TINY, golden as G
from cufhe_jax.models import Context, circuits, decrypt_bits, encrypt_bits

rng = np.random.default_rng(7)
sk = G.keygen(TINY, seed=1)
ek = G.make_eval_key(sk, seed=2)
ctx = Context(ek)

# --- Way 1: 8-bit ripple-carry adder over a batch of words ----------------
batch, nbits = 16, 8
a_vals = rng.integers(0, 256, batch)
b_vals = rng.integers(0, 256, batch)
bit = lambda v, i: (v >> i) & 1
enc_word = lambda v: [encrypt_bits(bit(v, i), sk, rng) for i in range(nbits)]
a_word, b_word = enc_word(a_vals), enc_word(b_vals)
zero = encrypt_bits(np.zeros(batch, dtype=int), sk, rng)

sum_bits, carry = circuits.ripple_carry_add(ctx, a_word, b_word, zero)
got = sum(decrypt_bits(s, sk).astype(int) << i
          for i, s in enumerate(sum_bits))
got += decrypt_bits(carry, sk).astype(int) << nbits
assert np.array_equal(got, a_vals + b_vals), (got, a_vals + b_vals)
print(f"circuits.ripple_carry_add: {batch} encrypted 8-bit additions OK")

# --- Way 2: the same adder as a netlist through the native scheduler ------
# (arbitrary circuits import the same way from Bristol Fashion text via
#  runtime.load_bristol/compile_bristol — benchmarks/aes.py runs a full
#  46,704-gate AES-128 through this path)
from cufhe_jax.runtime import build_ripple_adder, run_schedule

cb, wires = build_ripple_adder(nbits)       # C++ graph builder
sched = cb.compile()                        # levelize + DCE + schedule
ins = [*a_word, *b_word, zero]              # a bits, b bits, carry-in
outs = run_schedule(ctx, sched, ins)        # fused batched level programs
got2 = sum(decrypt_bits(s, sk).astype(int) << i for i, s in enumerate(outs))
assert np.array_equal(got2, a_vals + b_vals)
print(f"runtime scheduler netlist: {batch} additions OK "
      f"({sched.num_levels} levels)")

# --- Way 2b: a real workload netlist (SHA-256), plaintext-simulated -------
# The same importer/scheduler stack runs generated AES-128 and SHA-256;
# encrypted runs are benchmarks/aes.py and benchmarks/sha256.py. Here the
# scheduled SHA-256 circuit is executed on plaintext bits (the executor's
# oracle mode) to show the netlist tooling end-to-end without the ~10 min
# encrypted evaluation.
import hashlib

from cufhe_jax.runtime import netlists as NL
from cufhe_jax.runtime.bristol import compile_bristol
from cufhe_jax.runtime.executor import simulate_schedule

sha_sched, _ = compile_bristol(NL.sha256_block_bristol())
msg = b"hello, homomorphic world"
in_bits = [np.array([b]) for b in NL.bits_of(NL.sha256_pad(msg))]
digest = NL.bytes_of(np.concatenate(simulate_schedule(sha_sched, in_bits)))
assert digest == hashlib.sha256(msg).digest()
print(f"sha256 netlist: {sha_sched.num_gates} gates, digest matches hashlib")
