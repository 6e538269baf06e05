"""TOY8 encrypted processor: the kvsp-class workload.

The reference exists to serve the Virtual Secure Platform's encrypted-CPU
use case (reference README.md:2-7) but ships only gates; this validates a
complete processor cycle circuit (fetch/decode/ALU/control) built on the
native scheduler, first in plaintext against the ISA interpreter, then
fully encrypted end-to-end.
"""
import numpy as np
import pytest

from cufhe_jax.models import processor as TOY
from cufhe_jax.runtime.executor import simulate_schedule


def _sim_cycles(sched, programs, cycles):
    """Plaintext-simulate the cycle circuit for B programs, feeding the 12
    state bits back each cycle. Returns (acc[B], pc[B])."""
    roms = np.stack([TOY.assemble(p) for p in programs])   # [B, slots, bits]
    rom_bits = [roms[:, s, b] for s in range(TOY.PROG_SLOTS)
                for b in range(TOY.INSTR_BITS)]
    B = len(programs)
    state = [np.zeros(B, dtype=np.int64)] * (TOY.ACC_BITS + TOY.PC_BITS)
    for _ in range(cycles):
        state = [np.asarray(o) for o in
                 simulate_schedule(sched, rom_bits + state)]
    acc = sum(b.astype(np.int64) << i
              for i, b in enumerate(state[:TOY.ACC_BITS]))
    pc = sum(b.astype(np.int64) << i
             for i, b in enumerate(state[TOY.ACC_BITS:]))
    return acc, pc


PROGRAMS = {
    # every ALU op, plus fall-through past the end (PC wraps mod 16)
    "alu": [("ldi", 0x5A), ("add", 0x33), ("xor", 0xFF), ("and", 0x7E),
            ("or", 0x81)],
    # backward jump: infinite loop incrementing ACC (JMP taken every pass)
    "loop": [("ldi", 0), ("add", 1), ("jmp", 1)],
    # countdown with conditional exit: JZ untaken until ACC hits zero
    "countdown": [("ldi", 3), ("add", 0xFF), ("jz", 5), ("jmp", 1),
                  ("nop", 0), ("ldi", 0x99)],
    # JZ on a nonzero ACC must NOT be taken
    "jz_untaken": [("ldi", 7), ("jz", 0), ("add", 1)],
}


def test_interpreter_semantics():
    """Spot-check the plaintext oracle itself (hand-computed traces)."""
    assert TOY.interpret(PROGRAMS["alu"], 5) == ((((0x5A + 0x33) & 0xFF)
                                                  ^ 0xFF) & 0x7E | 0x81, 5)
    # loop: after 1 + 3*k cycles ACC == k+... trace: ldi,add,jmp,add,jmp,...
    assert TOY.interpret(PROGRAMS["loop"], 1) == (0, 1)
    assert TOY.interpret(PROGRAMS["loop"], 2) == (1, 2)
    assert TOY.interpret(PROGRAMS["loop"], 3) == (1, 1)
    assert TOY.interpret(PROGRAMS["loop"], 8) == (4, 2)
    # countdown: 3,2,1,0 then JZ fires into the ldi 0x99
    acc, pc = TOY.interpret(PROGRAMS["countdown"], 10)
    assert (acc, pc) == (0x99, 6)


@pytest.mark.parametrize("force_python", [False, True])
def test_cycle_circuit_matches_interpreter(force_python):
    """One compiled cycle circuit, stepped in plaintext, reproduces the ISA
    interpreter for every program in the table (batched: all programs run
    as lanes of one evaluation) and for random programs."""
    cb, _ = TOY.build_cycle(force_python=force_python)
    sched = cb.compile()
    progs = list(PROGRAMS.values())
    rng = np.random.default_rng(42)
    ops = list(TOY.OPCODES)
    for _ in range(4):
        progs.append([(ops[rng.integers(len(ops))],
                       int(rng.integers(256)))
                      for _ in range(int(rng.integers(1, 17)))])
    for cycles in (1, 4, 9):
        acc, pc = _sim_cycles(sched, progs, cycles)
        for lane, prog in enumerate(progs):
            want = TOY.interpret(prog, cycles)
            assert (acc[lane], pc[lane]) == want, (lane, cycles, prog)


def test_processor_encrypted(tiny_key, rng):
    """Fully encrypted execution: 3 different encrypted programs run as
    batch lanes for 4 cycles; decrypted (ACC, PC) match the interpreter."""
    from cufhe_jax.models.api import Context

    sk, ek = tiny_key
    ctx = Context(ek)
    cb, _ = TOY.build_cycle()
    sched = cb.compile()
    progs = [PROGRAMS["alu"], PROGRAMS["loop"], PROGRAMS["countdown"]]
    inputs = TOY.encrypt_state(progs, sk, rng)
    state = TOY.run_cycles(ctx, sched, inputs, cycles=4)
    acc, pc = TOY.decrypt_state(state, sk)
    for lane, prog in enumerate(progs):
        assert (acc[lane], pc[lane]) == TOY.interpret(prog, 4)


def test_processor_scan_matches_loop(tiny_key, rng):
    """run_cycles(scan=True) — the whole multi-cycle run as ONE compiled
    program — is bit-identical to the per-cycle loop."""
    from cufhe_jax.models.api import Context

    sk, ek = tiny_key
    ctx = Context(ek)
    cb, _ = TOY.build_cycle()
    sched = cb.compile()
    progs = [PROGRAMS["loop"], PROGRAMS["jz_untaken"]]
    inputs = TOY.encrypt_state(progs, sk, rng)
    looped = TOY.run_cycles(ctx, sched, inputs, cycles=3)
    scanned = TOY.run_cycles(ctx, sched, inputs, cycles=3, scan=True)
    for a, b in zip(looped, scanned):
        assert np.array_equal(np.asarray(a.data), np.asarray(b.data))
    acc, pc = TOY.decrypt_state(scanned, sk)
    for lane, prog in enumerate(progs):
        assert (acc[lane], pc[lane]) == TOY.interpret(prog, 3)
