"""Encrypted-integer layer: multi-output PBS + radix arithmetic.

The pbs_many primitive is tested uint32-exact against golden.pbs_many;
the integer ops are tested end-to-end (encrypt -> evaluate -> decrypt) on
the deterministic tiny sets, where decomposition/modswitch rounding is the
only noise.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from cufhe_jax import golden as G
from cufhe_jax import params as P
from cufhe_jax.models import (Context, IntCodec, IntContext, decrypt_bits,
                              decrypt_uint, encrypt_uint)
from cufhe_jax.models.integers import build_tv
from cufhe_jax.ops import bootstrap as B
from cufhe_jax.ops import keys as K


@pytest.fixture(scope="module")
def int_key():
    sk = G.keygen(P.TINY, seed=21)
    ek = G.make_eval_key(sk, seed=22)
    return sk, ek


@pytest.fixture(scope="module")
def int_n128_key():
    sk = G.keygen(P.TINY_N128, seed=23)
    ek = G.make_eval_key(sk, seed=24)
    return sk, ek


@pytest.mark.parametrize("backend", ["conv", "toeplitz"])
@pytest.mark.parametrize("theta", [0, 1, 2])
def test_pbs_many_bitexact(backend, theta, int_key, rng):
    """Multi-output PBS vs the golden model, uint32-exact, every J and
    rounding depth."""
    sk, ek = int_key
    p = sk.params
    keys = K.prepare_keys(ek)
    J = 1 << theta
    cts = [G.encrypt_bit(b, sk, rng) for b in (0, 1, 1, 0)]
    batch = jnp.asarray(np.stack(cts))
    tv = rng.integers(0, 1 << 32, p.lvl1.n,
                      dtype=np.uint64).astype(np.uint32)
    want = np.stack([G.pbs_many(c, tv, J, ek, theta=theta) for c in cts],
                    axis=1)
    got = np.asarray(B.pbs_many(batch, jnp.asarray(tv), J, keys, p,
                                backend, theta=theta))
    assert np.array_equal(got, want)


def test_pbs_many_pallas_bitexact(int_n128_key, rng):
    """The resolved ("auto") path through the rounded mod switch, at N=128."""
    sk, ek = int_n128_key
    p = sk.params
    keys = K.prepare_keys(ek, backends=(B.resolve_backend("auto", p),))
    cts = [G.encrypt_bit(b, sk, rng) for b in (1, 0)]
    batch = jnp.asarray(np.stack(cts))
    tv = rng.integers(0, 1 << 32, p.lvl1.n,
                      dtype=np.uint64).astype(np.uint32)
    want = np.stack([G.pbs_many(c, tv, 2, ek, theta=1) for c in cts],
                    axis=1)
    got = np.asarray(B.pbs_many(batch, jnp.asarray(tv), 2, keys, p,
                                "auto", theta=1))
    assert np.array_equal(got, want)


def test_build_tv_slots():
    """LUT geometry: slot centers map to their outputs, the wrap tail is
    the negated v=0 output."""
    N, b = 64, 2
    outs = [np.arange(4, dtype=np.uint32) * 1000 + 7]
    tv = build_tv(outs, b, N)
    dw = N >> b
    for v in range(4):
        assert tv[v * dw] == outs[0][v]
    assert tv[N - 1] == (-7) % (1 << 32)


@pytest.fixture(scope="module")
def int_ctx(int_key):
    sk, ek = int_key
    ctx = Context(ek, backend="conv")
    return sk, IntContext(ctx)


def test_add_sub_roundtrip(int_ctx, rng):
    sk, ictx = int_ctx
    xs = [3, 200, 255, 0]
    ys = [5, 77, 255, 0]
    x = encrypt_uint(xs, 8, sk, rng=rng)
    y = encrypt_uint(ys, 8, sk, rng=rng)
    s = ictx.add(x, y)
    assert decrypt_uint(s, sk) == [(a + b) % 256 for a, b in zip(xs, ys)]
    d = ictx.sub(x, y)
    assert decrypt_uint(d, sk) == [(a - b) % 256 for a, b in zip(xs, ys)]


def test_add_overflow_carry(int_ctx, rng):
    sk, ictx = int_ctx
    xs, ys = [250, 1], [10, 2]
    x = encrypt_uint(xs, 8, sk, rng=rng)
    y = encrypt_uint(ys, 8, sk, rng=rng)
    s, carry = ictx.add_full(x, y)
    assert decrypt_uint(s, sk) == [(a + b) % 256 for a, b in zip(xs, ys)]
    bits = decrypt_bits(ictx.digit_to_bool(carry), sk)
    assert bits.tolist() == [1, 0]


def test_scalar_and_neg(int_ctx, rng):
    sk, ictx = int_ctx
    x = encrypt_uint([100, 5], 8, sk, rng=rng)
    assert decrypt_uint(ictx.add_scalar(x, 200), sk) == [44, 205]
    assert decrypt_uint(ictx.sub_scalar(x, 7), sk) == [93, 254]
    assert decrypt_uint(ictx.neg(x), sk) == [156, 251]


def test_comparisons(int_ctx, rng):
    sk, ictx = int_ctx
    xs, ys = [9, 4, 7, 200], [4, 9, 7, 200]
    x = encrypt_uint(xs, 8, sk, rng=rng)
    y = encrypt_uint(ys, 8, sk, rng=rng)
    assert decrypt_bits(ictx.ge(x, y), sk).tolist() == [1, 0, 1, 1]
    assert decrypt_bits(ictx.lt(x, y), sk).tolist() == [0, 1, 0, 0]
    assert decrypt_bits(ictx.eq(x, y), sk).tolist() == [0, 0, 1, 1]
    assert decrypt_bits(ictx.eq_scalar(x, 7), sk).tolist() == [0, 0, 1, 0]


def test_apply_lut_and_bool_bridge(int_ctx, rng):
    sk, ictx = int_ctx
    x = encrypt_uint([0b1011, 0b0110], 4, sk, rng=rng)
    flipped = ictx.apply_lut(x, [1, 0])          # digitwise NOT at m=1
    assert decrypt_uint(flipped, sk) == [0b0100, 0b1001]
    # bool bridge round-trip: digit -> bool -> digit
    b = ictx.digit_to_bool(x.digits[:, 0])
    assert decrypt_bits(b, sk).tolist() == [1, 0]
    back = ictx.bool_to_digit(b)
    assert decrypt_bits(ictx.digit_to_bool(back), sk).tolist() == [1, 0]


def test_shift_digits(int_ctx, rng):
    sk, ictx = int_ctx
    x = encrypt_uint([0b0110, 0b1001], 4, sk, rng=rng)
    assert decrypt_uint(ictx.shift_digits(x, 1), sk) == [0b1100, 0b0010]
    assert decrypt_uint(ictx.shift_digits(x, -2), sk) == [0b0001, 0b0010]


def test_select_min_max(int_ctx, rng):
    sk, ictx = int_ctx
    xs, ys = [9, 4, 200, 0], [4, 9, 200, 255]
    x = encrypt_uint(xs, 8, sk, rng=rng)
    y = encrypt_uint(ys, 8, sk, rng=rng)
    sel = ictx.select(ictx.ge(x, y), x, y)
    assert decrypt_uint(sel, sk) == [max(a, b) for a, b in zip(xs, ys)]
    assert decrypt_uint(ictx.min_(x, y), sk) == \
        [min(a, b) for a, b in zip(xs, ys)]
    assert decrypt_uint(ictx.max_(x, y), sk) == \
        [max(a, b) for a, b in zip(xs, ys)]


def test_signed_roundtrip_and_compare(int_ctx, rng):
    from cufhe_jax.models import decrypt_int, encrypt_int
    sk, ictx = int_ctx
    xs, ys = [-3, 7, -8, 5], [2, -7, -8, 6]
    x = encrypt_int(xs, 4, sk, rng=rng)
    y = encrypt_int(ys, 4, sk, rng=rng)
    assert decrypt_int(x, sk) == xs
    assert decrypt_bits(ictx.ge_signed(x, y), sk).tolist() == \
        [int(a >= b) for a, b in zip(xs, ys)]
    assert decrypt_bits(ictx.lt_signed(x, y), sk).tolist() == \
        [int(a < b) for a, b in zip(xs, ys)]
    assert decrypt_int(ictx.min_signed(x, y), sk) == \
        [min(a, b) for a, b in zip(xs, ys)]
    assert decrypt_int(ictx.max_signed(x, y), sk) == \
        [max(a, b) for a, b in zip(xs, ys)]
    # signed add/sub are the unsigned ops (two's complement)
    assert decrypt_int(ictx.add(x, y), sk) == \
        [(a + b + 8) % 16 - 8 for a, b in zip(xs, ys)]


def test_abs(int_ctx, rng):
    from cufhe_jax.models import decrypt_int, encrypt_int
    sk, ictx = int_ctx
    xs = [-3, 7, -8, 0]                     # |-8| wraps to -8 (hardware)
    x = encrypt_int(xs, 4, sk, rng=rng)
    assert decrypt_int(ictx.abs_(x), sk) == [3, 7, -8, 0]


def test_divmod(int_ctx, rng):
    sk, ictx = int_ctx
    xs, ys = [13, 7, 9, 15], [3, 2, 4, 1]
    x = encrypt_uint(xs, 4, sk, rng=rng)
    y = encrypt_uint(ys, 4, sk, rng=rng)
    q, r = ictx.divmod_(x, y)
    assert decrypt_uint(q, sk) == [a // b for a, b in zip(xs, ys)]
    assert decrypt_uint(r, sk) == [a % b for a, b in zip(xs, ys)]


def test_div_by_zero_convention(int_ctx, rng):
    """Restoring-hardware convention: q = all ones, r = x."""
    sk, ictx = int_ctx
    x = encrypt_uint([9, 0], 4, sk, rng=rng)
    y = encrypt_uint([0, 0], 4, sk, rng=rng)
    q, r = ictx.divmod_(x, y)
    assert decrypt_uint(q, sk) == [15, 15]
    assert decrypt_uint(r, sk) == [9, 0]


def test_encrypted_shifts(int_ctx, rng):
    sk, ictx = int_ctx
    xs = [0b0110, 0b1001, 0b1111]
    amts = [1, 2, 5]                       # 5 >= bits: shifts to zero
    x = encrypt_uint(xs, 4, sk, rng=rng)
    a = encrypt_uint(amts, 3, sk, rng=rng)
    left = ictx.shift_left(x, a)
    assert decrypt_uint(left, sk) == [(v << s) & 0xF if s < 4 else 0
                                      for v, s in zip(xs, amts)]
    right = ictx.shift_right(x, a)
    assert decrypt_uint(right, sk) == [v >> s if s < 4 else 0
                                       for v, s in zip(xs, amts)]


def test_mul(int_ctx, rng):
    sk, ictx = int_ctx
    xs, ys = [13, 7], [11, 0]
    x = encrypt_uint(xs, 4, sk, rng=rng)
    y = encrypt_uint(ys, 4, sk, rng=rng)
    prod = ictx.mul(x, y)
    assert prod.bits == 8
    assert decrypt_uint(prod, sk) == [a * b for a, b in zip(xs, ys)]


def test_msg_bits_2_experimental(int_n128_key, rng):
    """Radix-4 digits (b=3) on the wider tiny set: the experimental
    higher-throughput codec stays correct where rounding noise allows."""
    sk, ek = int_n128_key
    codec = IntCodec(msg_bits=2)
    ictx = IntContext(Context(ek, backend="conv"), codec)
    xs, ys = [123, 250], [45, 6]
    x = encrypt_uint(xs, 8, sk, codec, rng=rng)
    y = encrypt_uint(ys, 8, sk, codec, rng=rng)
    assert x.ndigits == 4
    s = ictx.add(x, y)
    assert decrypt_uint(s, sk) == [(a + b) % 256 for a, b in zip(xs, ys)]


# ---------------------------------------------------------------------------
# msg_bits=2 operation coverage (VERDICT r4 #5: select/mul/divmod/shifts
# past msg_bits=1). TINY is deterministic (alpha=0), so these are exact.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int2_key():
    # TINY_Q: fine-grained keyswitch — radix-4's delta/2 = 2^26 margin
    # needs KS rounding quieter than TINY's ~2^23 tail to stay exact
    sk = G.keygen(P.TINY_Q, seed=25)
    ek = G.make_eval_key(sk, seed=26)
    return sk, ek


@pytest.fixture(scope="module")
def int2_ctx(int2_key):
    sk, ek = int2_key
    return sk, IntContext(Context(ek, backend="conv"), IntCodec(msg_bits=2))


def test_m2_select_min_max(int2_ctx, rng):
    sk, ictx = int2_ctx
    codec = ictx.codec
    xs, ys = [9, 4, 200, 0], [4, 9, 200, 255]
    x = encrypt_uint(xs, 8, sk, codec, rng=rng)
    y = encrypt_uint(ys, 8, sk, codec, rng=rng)
    assert x.ndigits == 4                      # radix-4
    sel = ictx.select(ictx.ge(x, y), x, y)
    assert decrypt_uint(sel, sk) == [max(a, b) for a, b in zip(xs, ys)]
    assert decrypt_uint(ictx.min_(x, y), sk) == \
        [min(a, b) for a, b in zip(xs, ys)]
    assert decrypt_uint(ictx.max_(x, y), sk) == \
        [max(a, b) for a, b in zip(xs, ys)]


def test_m2_eq(int2_ctx, rng):
    sk, ictx = int2_ctx
    codec = ictx.codec
    xs, ys = [9, 4, 7, 200], [4, 9, 7, 200]
    x = encrypt_uint(xs, 8, sk, codec, rng=rng)
    y = encrypt_uint(ys, 8, sk, codec, rng=rng)
    assert decrypt_bits(ictx.eq(x, y), sk).tolist() == [0, 0, 1, 1]


def test_m2_signed_compare_and_abs(int2_ctx, rng):
    from cufhe_jax.models import decrypt_int, encrypt_int
    sk, ictx = int2_ctx
    codec = ictx.codec
    xs, ys = [-3, 7, -8, 5], [2, -7, -8, 6]
    x = encrypt_int(xs, 4, sk, codec, rng=rng)
    y = encrypt_int(ys, 4, sk, codec, rng=rng)
    assert decrypt_bits(ictx.ge_signed(x, y), sk).tolist() == \
        [int(a >= b) for a, b in zip(xs, ys)]
    assert decrypt_int(ictx.min_signed(x, y), sk) == \
        [min(a, b) for a, b in zip(xs, ys)]
    assert decrypt_int(ictx.abs_(x), sk) == [3, 7, -8, 5]


def test_m2_encrypted_shifts(int2_ctx, rng):
    sk, ictx = int2_ctx
    codec = ictx.codec
    xs = [0b01100110, 0b10011001, 0b11111111, 0b00000001]
    amts = [1, 3, 9, 6]                    # 9 >= 8 bits: saturates to 0
    x = encrypt_uint(xs, 8, sk, codec, rng=rng)
    a = encrypt_uint(amts, 8, sk, codec, rng=rng)
    left = ictx.shift_left(x, a)
    assert decrypt_uint(left, sk) == [(v << s) & 0xFF if s < 8 else 0
                                      for v, s in zip(xs, amts)]
    right = ictx.shift_right(x, a)
    assert decrypt_uint(right, sk) == [v >> s if s < 8 else 0
                                       for v, s in zip(xs, amts)]


def test_m1_shift_saturate_tail(int_ctx, rng):
    """Wide amount register (S=6 bits for 4-bit values): all high bits
    collapse into the OR-tree saturate path (ADVICE r4)."""
    sk, ictx = int_ctx
    xs = [0b0110, 0b1001, 0b1111, 0b0001]
    amts = [1, 35, 16, 3]                  # 35, 16 hit only high bits
    x = encrypt_uint(xs, 4, sk, rng=rng)
    a = encrypt_uint(amts, 6, sk, rng=rng)
    left = ictx.shift_left(x, a)
    assert decrypt_uint(left, sk) == [(v << s) & 0xF if s < 4 else 0
                                      for v, s in zip(xs, amts)]


def test_m2_mul_needs_carry_space(int2_ctx, rng):
    sk, ictx = int2_ctx
    x = encrypt_uint([3, 2], 4, sk, ictx.codec, rng=rng)
    with pytest.raises(ValueError, match="buf_bits"):
        ictx.mul(x, x)


def test_m2_mul(int2_key, rng):
    """Radix-4 multiplier with the TFHE-rs-style message/carry codec
    (buf_bits = 2*msg_bits)."""
    sk, ek = int2_key
    codec = IntCodec(msg_bits=2, buf_bits=4)
    ictx = IntContext(Context(ek, backend="conv"), codec)
    xs, ys = [13, 7, 15, 9], [11, 0, 15, 6]
    x = encrypt_uint(xs, 4, sk, codec, rng=rng)
    y = encrypt_uint(ys, 4, sk, codec, rng=rng)
    prod = ictx.mul(x, y)
    assert prod.bits == 8
    assert decrypt_uint(prod, sk) == [a * b for a, b in zip(xs, ys)]


def test_m2_divmod(int2_ctx, rng):
    sk, ictx = int2_ctx
    codec = ictx.codec
    xs, ys = [213, 77, 9, 255], [13, 2, 40, 1]
    x = encrypt_uint(xs, 8, sk, codec, rng=rng)
    y = encrypt_uint(ys, 8, sk, codec, rng=rng)
    q, r = ictx.divmod_(x, y)
    assert decrypt_uint(q, sk) == [a // b for a, b in zip(xs, ys)]
    assert decrypt_uint(r, sk) == [a % b for a, b in zip(xs, ys)]


def test_m2_div_by_zero_convention(int2_ctx, rng):
    sk, ictx = int2_ctx
    codec = ictx.codec
    x = encrypt_uint([9, 0], 4, sk, codec, rng=rng)
    y = encrypt_uint([0, 0], 4, sk, codec, rng=rng)
    q, r = ictx.divmod_(x, y)
    assert decrypt_uint(q, sk) == [15, 15]
    assert decrypt_uint(r, sk) == [9, 0]


def test_theta_zero_matches_legacy_a_switch(int_key, rng):
    """theta=0 many-path differs from the legacy PBS only in b's rounding:
    with b's low switch bits zero the two are bit-identical."""
    sk, ek = int_key
    p = sk.params
    keys = K.prepare_keys(ek)
    ct = G.encrypt_bit(1, sk, rng)
    ct[p.lvl0.dim] &= np.uint32(~((1 << (32 - 1 - p.lvl1.nbit)) - 1)
                                & 0xFFFFFFFF)
    tv = rng.integers(0, 1 << 32, p.lvl1.n,
                      dtype=np.uint64).astype(np.uint32)
    batch = jnp.asarray(ct[None])
    legacy = np.asarray(B.programmable_bootstrap(batch, jnp.asarray(tv),
                                                 keys, p, "conv"))
    many = np.asarray(B.pbs_many(batch, jnp.asarray(tv), 1, keys, p,
                                 "conv", theta=0))[0]
    assert np.array_equal(legacy, many)


def test_divmod_segmented_bitexact(int_ctx, rng):
    """Host-segmented division (remainder carried between dispatches) is
    bit-identical to the single-scan program — the long-dispatch split a
    32-bit divide needs (the bench rig kills executions past ~65 s)."""
    import numpy as np
    sk, ictx = int_ctx
    xs, ys = [13, 7, 9, 15, 11, 0], [3, 2, 4, 1, 12, 5]
    x = encrypt_uint(xs, 4, sk, rng=rng)
    y = encrypt_uint(ys, 4, sk, rng=rng)
    q1, r1 = ictx.divmod_(x, y)
    q3, r3 = ictx.divmod_(x, y, segment=3)   # uneven split: 3 + 1
    assert np.array_equal(np.asarray(q1.digits), np.asarray(q3.digits))
    assert np.array_equal(np.asarray(r1.digits), np.asarray(r3.digits))
    assert decrypt_uint(q3, sk) == [a // b for a, b in zip(xs, ys)]


def test_m2_divmod_segmented_bitexact(int2_ctx, rng):
    import numpy as np
    sk, ictx = int2_ctx
    codec = ictx.codec
    xs, ys = [213, 77, 9, 255], [13, 2, 40, 3]
    x = encrypt_uint(xs, 8, sk, codec, rng=rng)
    y = encrypt_uint(ys, 8, sk, codec, rng=rng)
    q1, r1 = ictx.divmod_(x, y)
    q2, r2 = ictx.divmod_(x, y, segment=3)
    assert np.array_equal(np.asarray(q1.digits), np.asarray(q2.digits))
    assert np.array_equal(np.asarray(r1.digits), np.asarray(r2.digits))
    assert decrypt_uint(q2, sk) == [a // b for a, b in zip(xs, ys)]
