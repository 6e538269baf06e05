"""TOY8: running PROGRAMS the server cannot see.

The reference library was built for the Virtual Secure Platform — a CPU
whose program, data, and every intermediate value are TFHE ciphertexts
(reference README.md:2-7). This example runs such a machine end-to-end:
the client encrypts a small program and hands it to the "server" (this
process), which steps the processor cycle circuit homomorphically. The
server sees only ciphertexts: it cannot tell a jump from an add, or which
branch was taken — every cycle evaluates all paths and muxes under
encryption.

The batch axis runs B *different* encrypted programs per evaluation — the
batched analogue of the reference's streams (one program per lane).

Run:  python examples/04_encrypted_processor.py    # TINY params, CPU-fast
"""
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

jax.config.update("jax_platforms", "cpu")   # TINY demo: CPU is plenty

from cufhe_jax import TINY, golden as G
from cufhe_jax.models import Context, processor as TOY

rng = np.random.default_rng(11)
sk = G.keygen(TINY, seed=1)
ek = G.make_eval_key(sk, seed=2)

# --- client side: write + encrypt three different programs ----------------
programs = [
    # sum 1..4 by looping:           ACC ends at 10
    [("ldi", 0), ("add", 1), ("add", 2), ("add", 3), ("add", 4)],
    # countdown 3,2,1,0 then escape: ACC ends at 0x99
    [("ldi", 3), ("add", 0xFF), ("jz", 5), ("jmp", 1), ("nop", 0),
     ("ldi", 0x99)],
    # bit fiddling:                  ((0xF0 ^ 0xFF) | 0x80) & 0x8F = 0x8F
    [("ldi", 0xF0), ("xor", 0xFF), ("or", 0x80), ("and", 0x8F)],
]
CYCLES = 10
inputs = TOY.encrypt_state(programs, sk, rng)
print(f"encrypted {len(programs)} programs "
      f"({TOY.PROG_SLOTS}x{TOY.INSTR_BITS} ROM bits each)")

# --- server side: compile the cycle circuit once, step it blind -----------
ctx = Context(ek)
cb, _ = TOY.build_cycle()
sched = cb.compile()
print(f"cycle circuit: {sched.num_gates} gates in {len(sched.levels)} "
      f"levels; running {CYCLES} cycles...")
state = TOY.run_cycles(ctx, sched, inputs, cycles=CYCLES)

# --- client side: decrypt final machine state ------------------------------
acc, pc = TOY.decrypt_state(state, sk)
for lane, prog in enumerate(programs):
    want_acc, want_pc = TOY.interpret(prog, CYCLES)
    status = "ok" if (acc[lane], pc[lane]) == (want_acc, want_pc) else "FAIL"
    print(f"lane {lane}: ACC=0x{acc[lane]:02X} PC={pc[lane]:2d} "
          f"(expected 0x{want_acc:02X}/{want_pc}) {status}")
    assert status == "ok"
print("all encrypted program runs match the plaintext interpreter")
