"""CMUX-tree (vertical packing) lookup: encrypted table reads.

The reference ships the CMUX kernel (__CMUXNTT__, bootstrap_gpu.cu:197-285)
as the building block for kvsp's encrypted ROM/RAM reads but not the tree
itself; circuits.cmux_tree_lookup is that primitive. Verified (a) uint32-
exact against a golden-model CMUX tree and (b) end-to-end: the decrypted
selected word equals the plaintext table entry for every address.
"""
import numpy as np

from cufhe_jax import golden as G
from cufhe_jax.models import circuits
from cufhe_jax.models.api import Context, TrlweCtxt


def _setup(sk, rng, d, words):
    """Encrypt a 2^d-entry table of N-bit words as TRLWEs."""
    lp = sk.params.lvl1
    table = np.stack([G.trlwe_encrypt_bits(w, lp, sk.lvl1, rng)
                      for w in words])
    return TrlweCtxt(np.asarray(table)), table


def test_cmux_tree_matches_golden_and_plaintext(tiny_key, rng):
    sk, ek = tiny_key
    p = sk.params
    lp = p.lvl1
    ctx = Context(ek)
    d = 3
    words = rng.integers(0, 2, size=(1 << d, lp.n))
    leaves, table = _setup(sk, rng, d, words)

    for addr in (0, 3, 5, 7):
        bits = [(addr >> i) & 1 for i in range(d)]
        tgs = [G.trgsw_encrypt(b, lp, sk.lvl1, rng) for b in bits]
        sels = [ctx.prepare_trgsw(tg) for tg in tgs]

        got = np.asarray(circuits.cmux_tree_lookup(ctx, sels, leaves).data)
        assert got.shape == (1, lp.k + 1, lp.n)

        # (a) uint32-exact vs the golden model's tree
        want = table
        for tg in tgs:
            want = np.stack([G.cmux(tg, want[2 * i + 1], want[2 * i], lp)
                             for i in range(want.shape[0] // 2)])
        assert np.array_equal(got, want)

        # (b) the selected word decrypts to the plaintext table entry
        phase = G.trlwe_phase(got[0], lp, sk.lvl1)
        dec = (phase.astype(np.int64) >> 31) ^ 1   # +mu -> 1, -mu -> 0
        assert np.array_equal(dec, words[addr]), addr


def test_cmux_tree_selected_word_feeds_gate_path(tiny_key, rng):
    """Integration: tree-select a word, sample-extract+keyswitch slot 0
    back to lvl0, and decrypt — the full encrypted-ROM-read round trip."""
    from cufhe_jax.models.api import decrypt_bits

    sk, ek = tiny_key
    lp = sk.params.lvl1
    ctx = Context(ek)
    d = 2
    words = rng.integers(0, 2, size=(1 << d, lp.n))
    leaves, _ = _setup(sk, rng, d, words)
    for addr in range(1 << d):
        bits = [(addr >> i) & 1 for i in range(d)]
        sels = [ctx.prepare_trgsw(G.trgsw_encrypt(b, lp, sk.lvl1, rng))
                for b in bits]
        word = circuits.cmux_tree_lookup(ctx, sels, leaves)
        bit0 = ctx.sample_extract_and_keyswitch(word)
        assert decrypt_bits(bit0, sk)[0] == words[addr][0]


def test_cmux_tree_rejects_size_mismatch(tiny_key, rng):
    sk, ek = tiny_key
    lp = sk.params.lvl1
    ctx = Context(ek)
    words = rng.integers(0, 2, size=(4, lp.n))
    leaves, _ = _setup(sk, rng, 2, words)
    sels = [ctx.prepare_trgsw(G.trgsw_encrypt(0, lp, sk.lvl1, rng))]
    try:
        circuits.cmux_tree_lookup(ctx, sels, leaves)
    except ValueError:
        pass
    else:
        raise AssertionError("size mismatch not rejected")


def test_vertical_packing_full_read(tiny_key, rng):
    """2 tree bits x 2 word bits = 16-bit encrypted table; every address
    reads back its plaintext bit through the full vertical-packing path."""
    from cufhe_jax.models.api import decrypt_bits

    sk, ek = tiny_key
    lp = sk.params.lvl1
    ctx = Context(ek)
    tree_bits, word_bits = 2, 2
    words = rng.integers(0, 2, size=(1 << tree_bits, lp.n))
    leaves, _ = _setup(sk, rng, tree_bits, words)
    for addr in range(1 << (tree_bits + word_bits)):
        slot, wi = addr & 3, addr >> word_bits
        sels = [ctx.prepare_trgsw(
            G.trgsw_encrypt((addr >> i) & 1, lp, sk.lvl1, rng))
            for i in range(tree_bits + word_bits)]
        bit = circuits.vertical_packing_lookup(ctx, sels, leaves, word_bits)
        assert decrypt_bits(bit, sk)[0] == words[wi][slot], addr


def test_vertical_packing_word_bits_bounds(tiny_key, rng):
    sk, ek = tiny_key
    lp = sk.params.lvl1
    ctx = Context(ek)
    words = rng.integers(0, 2, size=(2, lp.n))
    leaves, _ = _setup(sk, rng, 1, words)
    sels = [ctx.prepare_trgsw(G.trgsw_encrypt(0, lp, sk.lvl1, rng))
            for _ in range(1 + lp.nbit + 1)]
    try:
        circuits.vertical_packing_lookup(ctx, sels, leaves, lp.nbit + 1)
    except ValueError:
        pass
    else:
        raise AssertionError("word_bits bound not enforced")


def test_vertical_packing_write_then_read(tiny_key, rng):
    """Oblivious write: for every address, write a fresh word, then read
    every table entry back — the written word changed, the others did
    not."""
    sk, ek = tiny_key
    lp = sk.params.lvl1
    ctx = Context(ek)
    d = 2
    words = rng.integers(0, 2, size=(1 << d, lp.n))
    leaves, _ = _setup(sk, rng, d, words)

    def read_plain(table, wi):
        phase = G.trlwe_phase(np.asarray(table.data)[wi], lp, sk.lvl1)
        return (phase.astype(np.int64) >> 31) ^ 1

    for addr in range(1 << d):
        new_bits = rng.integers(0, 2, lp.n)
        value = TrlweCtxt(np.asarray(
            G.trlwe_encrypt_bits(new_bits, lp, sk.lvl1, rng))[None])
        sels = [ctx.prepare_trgsw(
            G.trgsw_encrypt((addr >> i) & 1, lp, sk.lvl1, rng))
            for i in range(d)]
        new_table = circuits.vertical_packing_write(ctx, sels, leaves,
                                                    value)
        for wi in range(1 << d):
            want = new_bits if wi == addr else words[wi]
            assert np.array_equal(read_plain(new_table, wi), want), \
                (addr, wi)


def test_vertical_packing_write_rejects_size_mismatch(tiny_key, rng):
    sk, ek = tiny_key
    lp = sk.params.lvl1
    ctx = Context(ek)
    words = rng.integers(0, 2, size=(4, lp.n))
    leaves, _ = _setup(sk, rng, 2, words)
    value = TrlweCtxt(np.asarray(
        G.trlwe_encrypt_bits(words[0], lp, sk.lvl1, rng))[None])
    sels = [ctx.prepare_trgsw(G.trgsw_encrypt(0, lp, sk.lvl1, rng))]
    try:
        circuits.vertical_packing_write(ctx, sels, leaves, value)
    except ValueError:
        pass
    else:
        raise AssertionError("size mismatch not rejected")
