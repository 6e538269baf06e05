"""TOY8: a fully encrypted 8-bit processor — the kvsp-class workload.

The reference library exists to serve the Virtual Secure Platform, which
executes a CPU where the *program, the data, and every intermediate state*
are TFHE ciphertexts (reference README.md:2-7); the reference itself ships
only the gates. This module packages a complete (small) processor on top of
the native scheduler: one compiled cycle circuit evaluates instruction
fetch, decode, ALU, and control flow data-obliviously, and the host driver
feeds each cycle's encrypted output state back as the next cycle's input.
Branching works on encrypted conditions because every cycle computes ALL
paths and muxes — control flow never leaks.

ISA (3-bit opcode + 8-bit immediate, 16-slot program ROM, 8-bit ACC,
4-bit PC):

    0 NOP            1 LDI imm        2 ADD imm        3 AND imm
    4 XOR imm        5 OR  imm        6 JMP imm[0:4]   7 JZ  imm[0:4]

Because the batch axis carries independent lanes, one evaluation steps B
*different* encrypted programs simultaneously — the batched analogue of the
reference's streams-of-gates concurrency.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

PROG_SLOTS = 16      # instruction ROM entries
INSTR_BITS = 11      # 3-bit opcode + 8-bit immediate
ACC_BITS = 8
PC_BITS = 4

OPCODES: Dict[str, int] = {
    "nop": 0, "ldi": 1, "add": 2, "and": 3,
    "xor": 4, "or": 5, "jmp": 6, "jz": 7,
}


def assemble(program: Sequence[Tuple[str, int]]) -> np.ndarray:
    """[(mnemonic, imm), ...] -> [PROG_SLOTS, INSTR_BITS] bit matrix
    (LSB-first: bits 0..7 = immediate, bits 8..10 = opcode). Unused slots
    are NOPs."""
    assert len(program) <= PROG_SLOTS, "program too long"
    out = np.zeros((PROG_SLOTS, INSTR_BITS), dtype=np.int64)
    for s, (mn, imm) in enumerate(program):
        word = (OPCODES[mn] << 8) | (imm & 0xFF)
        out[s] = [(word >> b) & 1 for b in range(INSTR_BITS)]
    return out


def interpret(program: Sequence[Tuple[str, int]], cycles: int,
              acc: int = 0, pc: int = 0) -> Tuple[int, int]:
    """Plaintext reference semantics (the oracle for encrypted runs).
    Returns (acc, pc) after `cycles` steps."""
    rom = list(program) + [("nop", 0)] * (PROG_SLOTS - len(program))
    for _ in range(cycles):
        mn, imm = rom[pc % PROG_SLOTS]
        imm &= 0xFF
        nxt = (pc + 1) % PROG_SLOTS
        if mn == "ldi":
            acc = imm
        elif mn == "add":
            acc = (acc + imm) & 0xFF
        elif mn == "and":
            acc &= imm
        elif mn == "xor":
            acc ^= imm
        elif mn == "or":
            acc |= imm
        elif mn == "jmp":
            nxt = imm & (PROG_SLOTS - 1)
        elif mn == "jz" and acc == 0:
            nxt = imm & (PROG_SLOTS - 1)
        pc = nxt
    return acc, pc


def build_cycle(force_python: bool = False):
    """One processor cycle as a circuit: inputs are the encrypted ROM
    (PROG_SLOTS * INSTR_BITS bits) then ACC (8) then PC (4); outputs are
    next ACC (8) then next PC (4). Compiled once; the scheduler's
    NOT/COPY absorption and mux grouping apply as to any netlist.

    Returns (builder, meta) with meta = {"rom": [[bit wires]], "acc": [...],
    "pc": [...]}."""
    from ..runtime import CircuitBuilder

    cb = CircuitBuilder(force_python=force_python)
    rom = [[cb.input() for _ in range(INSTR_BITS)]
           for _ in range(PROG_SLOTS)]
    acc = [cb.input() for _ in range(ACC_BITS)]
    pc = [cb.input() for _ in range(PC_BITS)]

    # -- fetch: 16-way mux tree over PC, per instruction bit --------------
    def mux_tree(leaves: List[int], sel: List[int]) -> int:
        lvl = leaves
        for s in sel:                       # LSB-first selection
            lvl = [cb.gate("mux", s, lvl[i + 1], lvl[i])
                   for i in range(0, len(lvl), 2)]
        return lvl[0]

    instr = [mux_tree([rom[s][b] for s in range(PROG_SLOTS)], pc)
             for b in range(INSTR_BITS)]
    imm = instr[:8]
    opc = instr[8:11]

    # -- decode: opcode one-hot (NOTs absorb into gate variants) ----------
    nop = [cb.gate("not", b) for b in opc]

    def op_is(code: int) -> int:
        b0 = opc[0] if code & 1 else nop[0]
        b1 = opc[1] if code & 2 else nop[1]
        b2 = opc[2] if code & 4 else nop[2]
        return cb.gate("and", cb.gate("and", b0, b1), b2)

    is_op = {name: op_is(code) for name, code in OPCODES.items()
             if name != "nop"}

    # -- ALU ----------------------------------------------------------------
    def add8(a: List[int], b: List[int]) -> List[int]:
        out, c = [], None
        for i in range(ACC_BITS):
            s1 = cb.gate("xor", a[i], b[i])
            if c is None:
                out.append(s1)
                c = cb.gate("and", a[i], b[i])
            else:
                out.append(cb.gate("xor", s1, c))
                if i < ACC_BITS - 1:        # last carry unused (mod 256)
                    c = cb.gate("or", cb.gate("and", a[i], b[i]),
                                cb.gate("and", s1, c))
        return out

    results = {
        "ldi": imm,
        "add": add8(acc, imm),
        "and": [cb.gate("and", a, b) for a, b in zip(acc, imm)],
        "xor": [cb.gate("xor", a, b) for a, b in zip(acc, imm)],
        "or": [cb.gate("or", a, b) for a, b in zip(acc, imm)],
    }

    # -- ACC writeback: mux chain over the op one-hot (NOP keeps ACC) -----
    acc_next = list(acc)
    for name, res in results.items():
        sel = is_op[name]
        acc_next = [cb.gate("mux", sel, r, cur)
                    for r, cur in zip(res, acc_next)]

    # -- control flow -------------------------------------------------------
    # zero flag over the CURRENT ACC (JZ tests the pre-cycle accumulator)
    z = acc[0]
    for b in acc[1:]:
        z = cb.gate("or", z, b)
    zero = cb.gate("not", z)
    taken = cb.gate("or", is_op["jmp"], cb.gate("and", is_op["jz"], zero))

    # PC + 1 (4-bit increment, wraps): bit 0 flips, higher bits xor the
    # AND-chain carry of all lower bits
    inc: List[int] = []
    carry = None
    for i in range(PC_BITS):
        if carry is None:
            inc.append(cb.gate("not", pc[i]))
            carry = pc[i]
        else:
            inc.append(cb.gate("xor", pc[i], carry))
            if i < PC_BITS - 1:
                carry = cb.gate("and", pc[i], carry)
    pc_next = [cb.gate("mux", taken, imm[i], inc[i])
               for i in range(PC_BITS)]

    for w in acc_next:
        cb.output(w)
    for w in pc_next:
        cb.output(w)
    return cb, {"rom": rom, "acc": acc, "pc": pc}


def encrypt_state(programs: Sequence[Sequence[Tuple[str, int]]], sk, rng):
    """Encrypt B programs (one per batch lane) plus zeroed ACC/PC into the
    cycle circuit's input order. Returns a list of Ctxt batches."""
    from .api import encrypt_bits

    roms = np.stack([assemble(p) for p in programs])   # [B, slots, bits]
    inputs = []
    for s in range(PROG_SLOTS):
        for b in range(INSTR_BITS):
            inputs.append(encrypt_bits(roms[:, s, b], sk, rng))
    B = len(programs)
    zeros = np.zeros(B, dtype=np.int64)
    state = [encrypt_bits(zeros, sk, rng)
             for _ in range(ACC_BITS + PC_BITS)]
    return inputs + state


def run_cycles(ctx, sched, inputs, cycles: int, scan: bool = False):
    """Run `cycles` processor steps: each cycle's 12 output state bits feed
    back as the next cycle's ACC/PC inputs (ROM ciphertexts are reused).
    Returns the final [ACC bits + PC bits] Ctxts.

    scan=True runs the WHOLE multi-cycle execution as one compiled program
    (runtime.run_schedule_loop: lax.scan over the cycle circuit) — one
    dispatch per run instead of cycles x levels, the latency path for a
    sequential encrypted machine."""
    from ..runtime import run_schedule, run_schedule_loop

    n_state = ACC_BITS + PC_BITS
    n_rom = PROG_SLOTS * INSTR_BITS
    if scan:
        feedback = [(o, n_rom + o) for o in range(n_state)]
        return run_schedule_loop(ctx, sched, inputs, cycles, feedback)
    rom_ins = inputs[:n_rom]
    state = inputs[n_rom:]
    for _ in range(cycles):
        state = run_schedule(ctx, sched, rom_ins + state)
    return state


def decrypt_state(state, sk) -> Tuple[np.ndarray, np.ndarray]:
    """[12 Ctxts] -> (acc values [B], pc values [B])."""
    from .api import decrypt_bits

    bits = [decrypt_bits(ct, sk).astype(np.int64) for ct in state]
    acc = sum(b << i for i, b in enumerate(bits[:ACC_BITS]))
    pc = sum(b << i for i, b in enumerate(bits[ACC_BITS:]))
    return acc, pc
