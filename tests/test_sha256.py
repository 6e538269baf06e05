"""SHA-256 netlist generation + plaintext execution vs hashlib.

Companion workload to AES-128 (tests/test_aes.py): the generated circuit
runs through the same importer -> native scheduler -> executor stack; the
encrypted run is benchmarks/sha256.py.
"""
import hashlib

import numpy as np
import pytest

from cufhe_jax.runtime import netlists as NL
from cufhe_jax.runtime.bristol import compile_bristol
from cufhe_jax.runtime.executor import allocate_slots, simulate_schedule


def test_adders_and_pad():
    # constant adder vs generic adder vs integer arithmetic, exhaustively
    # random; padding matches the FIPS one-block layout
    rng = np.random.default_rng(1)
    for _ in range(4):
        a, b = (int(x) for x in rng.integers(0, 1 << 32, 2, dtype=np.uint64))
        w = NL.BristolWriter()
        aw = w.inputs(32)
        s1 = NL._add32(w, aw, [w.gate("EQ", (b >> i) & 1) for i in range(32)])
        s2 = NL._addc32(w, aw, b)
        sched, _ = compile_bristol(w.finalize(s1 + s2))
        bits = [np.array([(a >> i) & 1]) for i in range(32)]
        out = np.concatenate(simulate_schedule(sched, bits))
        v1 = sum(int(out[i]) << i for i in range(32))
        v2 = sum(int(out[32 + i]) << i for i in range(32))
        assert v1 == v2 == (a + b) % (1 << 32)
    assert NL.sha256_pad(b"abc")[:4] == b"abc\x80"
    assert NL.sha256_pad(b"abc")[-8:] == (24).to_bytes(8, "big")


@pytest.fixture(scope="module")
def sha_sched():
    return compile_bristol(NL.sha256_block_bristol())[0]


def test_sha256_netlist_plaintext(sha_sched):
    """Generated circuit == hashlib.sha256 on canonical + random inputs
    (batched plaintext simulation through the scheduled circuit)."""
    rng = np.random.default_rng(2)
    msgs = [b"", b"abc",
            b"The quick brown fox jumps over the lazy dog"] + \
        [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
         for n in rng.integers(1, 56, 5)]
    in_bits = np.array([NL.bits_of(NL.sha256_pad(m)) for m in msgs]).T
    out = np.stack(simulate_schedule(sha_sched, list(in_bits)))
    for i, m in enumerate(msgs):
        assert NL.bytes_of(out[:, i]) == hashlib.sha256(m).digest(), m


def test_sha256_slot_allocation_scales(sha_sched):
    """Liveness-recycled register file stays far below the wire count
    (the executor-scaling property AES relies on, at 2.4x the gates)."""
    slots = allocate_slots(sha_sched)
    n_slots = max(slots.values()) + 1
    assert n_slots < sha_sched.num_wires / 20, n_slots
    assert sha_sched.num_gates > 100_000


def test_sha256_multiblock_chained():
    """Arbitrary-length messages via the chainable compression circuit:
    one execution per padded block, output state feeding the next block's
    state input (covers the 55/56-byte padding boundary and a 4-block
    message)."""
    import hashlib
    sched, _ = compile_bristol(NL.sha256_compress_bristol())
    rng = np.random.default_rng(4)
    msgs = [b"abc",
            bytes(rng.integers(0, 256, 55, dtype=np.uint8)),
            bytes(rng.integers(0, 256, 56, dtype=np.uint8)),
            bytes(rng.integers(0, 256, 200, dtype=np.uint8))]
    for m in msgs:
        state = np.array(NL.sha256_iv_bits())[:, None]
        for blk in NL.sha256_pad_blocks(m):
            in_bits = np.concatenate(
                [np.array(NL.bits_of(blk))[:, None], state])
            state = np.stack(simulate_schedule(sched, list(in_bits)))
        assert NL.bytes_of(state[:, 0]) == hashlib.sha256(m).digest(), len(m)
