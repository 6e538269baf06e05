"""Composite encrypted circuits built from the gate set.

The reference exposes only single gates; circuits like these are its intended
use-case (the Virtual Secure Platform runs a whole CPU out of them,
README.md:2-7). Each circuit here is a host-side composition of the jitted
batched gate programs — the analogue of chaining `g`-prefixed device-resident
gates on a stream (cufhe_gates_gpu.cu:161-167).

All circuits operate bitwise on batches: a "word" is a list of Ctxt batches,
LSB first, so a single circuit evaluation processes B independent words.
"""
from __future__ import annotations

from typing import List, Sequence

from .api import Context, Ctxt


def half_adder(ctx: Context, a: Ctxt, b: Ctxt) -> tuple[Ctxt, Ctxt]:
    """(sum, carry)."""
    return ctx.xor(a, b), ctx.and_(a, b)


def full_adder(ctx: Context, a: Ctxt, b: Ctxt, cin: Ctxt
               ) -> tuple[Ctxt, Ctxt]:
    """(sum, carry-out) — 5 bootstrapped gates."""
    s1 = ctx.xor(a, b)
    s = ctx.xor(s1, cin)
    c1 = ctx.and_(a, b)
    c2 = ctx.and_(s1, cin)
    return s, ctx.or_(c1, c2)


def ripple_carry_add(ctx: Context, a: Sequence[Ctxt], b: Sequence[Ctxt],
                     cin: Ctxt) -> tuple[List[Ctxt], Ctxt]:
    """n-bit adder, LSB first. Returns (sum bits, carry-out)."""
    assert len(a) == len(b)
    out = []
    c = cin
    for ai, bi in zip(a, b):
        s, c = full_adder(ctx, ai, bi, c)
        out.append(s)
    return out, c


def equals(ctx: Context, a: Sequence[Ctxt], b: Sequence[Ctxt]) -> Ctxt:
    """Encrypted equality of two n-bit words."""
    bits = [ctx.xnor(ai, bi) for ai, bi in zip(a, b)]
    acc = bits[0]
    for bit in bits[1:]:
        acc = ctx.and_(acc, bit)
    return acc


def select_word(ctx: Context, sel: Ctxt, a: Sequence[Ctxt],
                b: Sequence[Ctxt]) -> List[Ctxt]:
    """sel ? a : b, bitwise Mux."""
    return [ctx.mux(sel, ai, bi) for ai, bi in zip(a, b)]


def ripple_carry_sub(ctx: Context, a: Sequence[Ctxt], b: Sequence[Ctxt]
                     ) -> tuple[List[Ctxt], Ctxt]:
    """a - b via two's complement: a + ~b + 1. Returns (diff bits, borrow-out
    complement: 1 iff a >= b)."""
    assert len(a) == len(b)
    out = []
    c: Ctxt = None  # type: ignore
    for i, (ai, bi) in enumerate(zip(a, b)):
        nb = ctx.not_(bi)
        if i == 0:
            # carry-in = 1: sum = a ^ ~b ^ 1 = xnor; carry = a | ~b
            out.append(ctx.xnor(ai, nb))
            c = ctx.or_(ai, nb)
        else:
            s1 = ctx.xor(ai, nb)
            out.append(ctx.xor(s1, c))
            c = ctx.or_(ctx.and_(ai, nb), ctx.and_(s1, c))
    return out, c


def less_than(ctx: Context, a: Sequence[Ctxt], b: Sequence[Ctxt]) -> Ctxt:
    """Encrypted unsigned a < b (1 iff a < b): NOT of the subtractor's
    carry-out."""
    _, geq = ripple_carry_sub(ctx, a, b)
    return ctx.not_(geq)


def popcount(ctx: Context, bits: Sequence[Ctxt]) -> List[Ctxt]:
    """Population count of encrypted bits via a carry-save adder tree;
    returns the count LSB-first (ceil(log2(n+1)) output bits)."""
    weights: List[List[Ctxt]] = [list(bits)]
    out: List[Ctxt] = []
    w = 0
    while w < len(weights):
        cur = weights[w]

        def carry_to(c: Ctxt) -> None:
            if w + 1 == len(weights):
                weights.append([])
            weights[w + 1].append(c)

        while len(cur) >= 3:
            x, y, z = cur.pop(), cur.pop(), cur.pop()
            s, c = full_adder(ctx, x, y, z)
            cur.append(s)
            carry_to(c)
        if len(cur) == 2:
            s, c = half_adder(ctx, cur.pop(), cur.pop())
            cur.append(s)
            carry_to(c)
        out.append(cur[0])
        w += 1
    return out


def multiply(ctx: Context, a: Sequence[Ctxt], b: Sequence[Ctxt]
             ) -> List[Ctxt]:
    """Unsigned product of an n-bit and an m-bit word (LSB first): AND
    partial products reduced column-by-column with a carry-save tree (the
    popcount pattern), one final bit per column. Returns up to n+m bits;
    structurally-zero top columns (possible for 1-bit operands) are
    omitted."""
    n, m = len(a), len(b)
    cols: List[List[Ctxt]] = [[] for _ in range(n + m)]
    for j in range(m):
        for i in range(n):
            cols[i + j].append(ctx.and_(a[i], b[j]))
    out: List[Ctxt] = []
    for w, cur in enumerate(cols):
        def carry_to(c: Ctxt) -> None:
            if w + 1 < len(cols):
                cols[w + 1].append(c)
        while len(cur) >= 3:
            s, c = full_adder(ctx, cur.pop(), cur.pop(), cur.pop())
            cur.append(s)
            carry_to(c)
        if len(cur) == 2:
            s, c = half_adder(ctx, cur.pop(), cur.pop())
            cur.append(s)
            carry_to(c)
        if cur:
            out.append(cur[0])
    return out


def cmux_tree_lookup(ctx: Context, sels: Sequence[dict],
                     leaves) -> "TrlweCtxt":
    """Vertical-packing table lookup — the kvsp ROM/RAM-read primitive the
    reference's CMUX exists to serve (__CMUXNTT__, bootstrap_gpu.cu:197-285;
    the reference ships the single kernel, not the tree).

    Selects entry `addr` out of a table of 2^d TRLWE words entirely under
    encryption: `leaves` is a TrlweCtxt whose batch axis is the table
    ([2^d, k+1, N], each word packing up to N bits), and `sels` holds the
    d address bits as prepared TRGSW ciphertexts (Context.prepare_trgsw),
    LSB first. Returns the selected word as a [1, k+1, N] TrlweCtxt.

    Batched shape: every level of the binary tree halves the table with ONE
    batched CMUX program (all pairs of a level share that level's selector
    bit), so a 2^d-entry lookup is d dispatches of matrix work instead of the
    2^d - 1 separate kernel launches a stream-per-pair port would issue.
    """
    from .api import TrlweCtxt

    data = leaves.data
    if data.shape[0] != 1 << len(sels):
        raise ValueError(f"table has {data.shape[0]} entries; "
                         f"{len(sels)} selector bits need "
                         f"{1 << len(sels)}")
    for tg in sels:   # LSB first: bit 0 picks between adjacent entries
        data = ctx.cmux(tg, TrlweCtxt(data[1::2]),
                        TrlweCtxt(data[0::2])).data
    return TrlweCtxt(data)


def vertical_packing_lookup(ctx: Context, sels: Sequence[dict],
                            leaves, word_bits: int):
    """Full vertical-packing read: ONE encrypted bit out of a table of
    2^(d - word_bits) TRLWE words x 2^word_bits slots, addressed entirely
    by TRGSW ciphertexts (the complete kvsp memory-read shape; the
    reference ships only the per-node CMUX kernel,
    bootstrap_gpu.cu:197-285).

    sels: all d address bits, LSB first — sels[:word_bits] select the slot
    inside a word, sels[word_bits:] walk the CMUX tree over words. The
    slot walk is CMUX-with-monomial-rotation: bit i conditionally
    multiplies the selected word by X^(-2^i) (a negacyclic roll, plain
    elementwise work), so after all low bits the addressed slot sits at coefficient 0,
    which sample-extract + keyswitch returns to the lvl0 gate domain.
    """
    import jax.numpy as jnp

    from ..ops import poly
    from .api import TrlweCtxt

    lp = ctx.params.lvl1
    if not 0 <= word_bits <= lp.nbit:
        raise ValueError(f"word_bits must be in [0, {lp.nbit}]")
    word = cmux_tree_lookup(ctx, sels[word_bits:], leaves)
    for i in range(word_bits):
        shift = (2 * lp.n - (1 << i)) % (2 * lp.n)
        bar = jnp.full((word.data.shape[0],), shift, dtype=jnp.uint32)
        rot = TrlweCtxt(poly.rotate_by_xai(word.data, bar, lp))
        word = ctx.cmux(sels[i], rot, word)
    return ctx.sample_extract_and_keyswitch(word)


def vertical_packing_write(ctx: Context, sels: Sequence[dict],
                           leaves, value):
    """Oblivious encrypted-RAM write: replace table word `addr` with
    `value` without revealing which word changed (the write half of the
    kvsp memory model; the reference ships only the CMUX kernel).

    leaves: TrlweCtxt table [2^d, k+1, N]; sels: the d address bits as
    prepared TRGSW ciphertexts, LSB first; value: TrlweCtxt [1, k+1, N].
    Returns the new table.

    Invariant construction, one batched CMUX per address bit: A starts as
    `value` broadcast to every slot; after bit j, A[w] == value where w
    matches addr on the low j+1 bits and A[w] == mem[w] otherwise — the
    branch pairing per word is plaintext indexing (bit j of w), so each
    level is ONE batched CMUX program over all 2^d words.

    Note every word (touched or not) passes through d CMUX levels, so one
    write adds d external products of noise to the whole table — inherent
    to oblivious writes; budget with benchmarks/noise.py --cmux-depth and
    refresh words periodically (Context.refresh).
    """
    import jax.numpy as jnp
    import numpy as np

    from .api import TrlweCtxt

    mem = leaves.data
    M = mem.shape[0]
    if M != 1 << len(sels):
        raise ValueError(f"table has {M} entries; {len(sels)} selector "
                         f"bits need {1 << len(sels)}")
    A = jnp.broadcast_to(value.data, mem.shape)
    for j, tg in enumerate(sels):
        bitj = ((np.arange(M) >> j) & 1)[:, None, None].astype(bool)
        c1 = jnp.where(bitj, A, mem)      # selector bit 1: words with wj=1
        c0 = jnp.where(bitj, mem, A)      # selector bit 0: words with wj=0
        A = ctx.cmux(tg, TrlweCtxt(c1), TrlweCtxt(c0)).data
    return TrlweCtxt(A)
