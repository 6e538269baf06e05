"""Encrypted multi-bit integers on programmable bootstrapping.

Beyond-parity layer (the reference is gate-only; its intended workloads —
kvsp processors, adders — are built from 10+ gate bootstraps per arithmetic
bit). Here an integer is a little-endian vector of radix-2^m *digits*, each
a lvl0 TLWE encrypting value v in [0, 2^m) at phase v*Delta:

    Delta = 2^32 / 2^(b+1),  b = buf_bits = msg_bits + 1

The extra buffer bit b > m holds carries ACCUMULATED LINEARLY (ciphertext
adds are free and exact on the torus), and the top "padding" bit keeps every
legal phase in [0, 2^31) so a negacyclic LUT is single-valued. A full adder
is then ONE blind rotation via the multi-output bootstrap (ops.bootstrap.
pbs_many): t = x_d + y_d + carry is a plain ciphertext sum, and the sum
digit (t mod 2^m) and carry digit (t >> m) come out of the same rotation as
two interleaved LUTs. Compare ~5 gate bootstraps per full-adder bit in the
reference's own netlist model (test/ circuits) — and 2 per bit for MUX-based
adders — vs 1/(msg_bits) rotations per bit here.

Noise budget (the decision margin of a LUT slot is Delta/2): an adder input
is at worst the sum of three fresh bootstrap outputs, std sqrt(3)*sigma_pbs,
plus the theta=1 mod-switch rounding. At the TFHEpp 128-bit set
(sigma_pbs ~ 2^24.85 measured, benchmarks/noise.py):

    msg_bits=1 (b=2): Delta/2 = 2^28 -> ~4.6 sigma  (production-viable)
    msg_bits=2 (b=3): Delta/2 = 2^27 -> ~2.3 sigma  (EXPERIMENTAL: percent-
                       level per-digit error; use for demos/short circuits)

benchmarks/integers.py measures both margins empirically; all ops here are
uint32-exact vs golden.pbs_many (noise is in the ciphertexts, not the
implementation).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import golden as G
from ..ops import bootstrap as B
from ..rng import resolve_rng
from .api import Context, Ctxt

U32 = jnp.uint32
_MOD = 1 << 32


@dataclasses.dataclass(frozen=True)
class IntCodec:
    """Digit encoding: msg_bits per digit, one carry-buffer bit, one
    padding bit. buf_bits defaults to msg_bits + 1 (exactly the headroom
    a ripple full adder needs: x + y + carry <= 2^(m+1) - 1)."""
    msg_bits: int = 1
    buf_bits: Optional[int] = None

    def __post_init__(self):
        if self.buf_bits is None:
            object.__setattr__(self, "buf_bits", self.msg_bits + 1)
        assert self.buf_bits >= self.msg_bits + 1

    @property
    def base(self) -> int:
        return 1 << self.msg_bits

    @property
    def delta(self) -> int:
        return 1 << (31 - self.buf_bits)

    def digits_for(self, bits: int) -> int:
        return -(-bits // self.msg_bits)


@dataclasses.dataclass
class IntCtxt:
    """A batch of encrypted unsigned integers: digits [B, D, n0+1] uint32,
    little-endian radix-2^msg_bits. Digits are always *clean* (fresh from
    encryption or a bootstrap, value < 2^msg_bits)."""
    digits: jnp.ndarray
    codec: IntCodec

    @property
    def batch(self) -> int:
        return self.digits.shape[0]

    @property
    def ndigits(self) -> int:
        return self.digits.shape[1]

    @property
    def bits(self) -> int:
        return self.ndigits * self.codec.msg_bits


# ---------------------------------------------------------------------------
# Test-polynomial (LUT) construction
# ---------------------------------------------------------------------------

def build_tv(outs: Sequence[np.ndarray], buf_bits: int, N: int) -> np.ndarray:
    """Interleave J LUTs into one test polynomial for pbs_many.

    outs: J arrays of 2^buf_bits uint32 torus outputs. Slot geometry:
    value v sits at phase v*Delta -> windows [v*dw - dw/2, v*dw + dw/2)
    with dw = N >> buf_bits coefficients per slot; tv[x] = outs[x % J][v(x)]
    so extraction at coefficient j (window w + j, w 2^theta-aligned) reads
    LUT j. The tail x >= N - dw/2 is the negacyclic wrap of v=0's negative
    noise lobe: extraction negates there, so it stores -outs[j][0]."""
    J = len(outs)
    dw = N >> buf_bits
    assert dw >= 2 * J, (dw, J, "LUT slots too narrow for interleaving")
    x = np.arange(N)
    v = (x + dw // 2) // dw                     # 0 .. 2^buf_bits
    nslots = 1 << buf_bits
    tv = np.zeros(N, dtype=np.uint32)
    for j in range(J):
        o = np.asarray(outs[j], dtype=np.uint32)
        assert o.shape == (nslots,)
        col = np.where(v < nslots, o[np.minimum(v, nslots - 1)],
                       (-o[0].astype(np.int64)) % _MOD).astype(np.uint32)
        sel = (x % J) == j
        tv[sel] = col[sel]
    return tv


def _enc_vals(vals: np.ndarray, codec: IntCodec) -> np.ndarray:
    return ((np.asarray(vals, dtype=np.uint64) * codec.delta) % _MOD).astype(
        np.uint32)


# ---------------------------------------------------------------------------
# Client side
# ---------------------------------------------------------------------------

def encrypt_uint(values: Sequence[int], bits: int, sk: G.SecretKey,
                 codec: IntCodec = IntCodec(),
                 rng: Optional[np.random.Generator] = None) -> IntCtxt:
    """Encrypt a batch of unsigned integers (client side)."""
    rng = resolve_rng(rng=rng)
    D = codec.digits_for(bits)
    m = codec.msg_bits
    digs = np.array([[(int(val) >> (m * d)) & (codec.base - 1)
                      for d in range(D)] for val in values],
                    dtype=np.uint32)                        # [B, D]
    mus = _enc_vals(digs, codec).reshape(-1)
    cts = G.tlwe_encrypt_batch(mus, sk.lvl0, sk.params.lvl0.alpha, rng)
    return IntCtxt(jnp.asarray(cts.reshape(len(values), D, -1)), codec)


def encrypt_int(values: Sequence[int], bits: int, sk: G.SecretKey,
                codec: IntCodec = IntCodec(),
                rng: Optional[np.random.Generator] = None) -> IntCtxt:
    """Encrypt SIGNED integers as two's complement mod 2^bits. (Python's
    arithmetic right shift makes encrypt_uint's digit extraction already
    produce the two's-complement digits for negative inputs; this alias
    documents the intent and range-checks.)"""
    for v in values:
        if not -(1 << (bits - 1)) <= int(v) < (1 << (bits - 1)):
            raise ValueError(f"{v} out of range for int{bits}")
    return encrypt_uint(values, bits, sk, codec, rng=rng)


def decrypt_int(x: IntCtxt, sk: G.SecretKey) -> list:
    """Decrypt as SIGNED two's-complement integers."""
    mod = 1 << x.bits
    return [v - mod if v >= mod // 2 else v for v in decrypt_uint(x, sk)]


def decrypt_uint(x: IntCtxt, sk: G.SecretKey) -> list:
    """Decrypt a batch of encrypted integers (client side)."""
    data = np.asarray(jax.device_get(x.digits))
    codec = x.codec
    m = codec.msg_bits
    out = []
    for row in data:
        val = 0
        for d, ct in enumerate(row):
            ph = int(G.tlwe_phase(ct, sk.lvl0))
            v = int(round(ph / codec.delta)) % (1 << (codec.buf_bits + 1))
            val += (v & (codec.base - 1)) << (m * d)
        out.append(val)
    return out


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------

class IntContext:
    """Server-side encrypted-integer evaluator over a gate Context.

    Every method is one (or a few) jitted programs cached per shape; the
    per-digit carry chain of add/sub runs as a lax.scan INSIDE one program
    (one dispatch per whole addition, like Context.gate_chain). Mesh
    sharding rides the wrapped Context's mesh (digit arrays are
    batch-leading)."""

    def __init__(self, ctx: Context, codec: IntCodec = IntCodec()):
        self.ctx = ctx
        self.codec = codec
        p = ctx.params
        N = p.lvl1.n
        m, b = codec.msg_bits, codec.buf_bits
        d = codec.delta
        vs = np.arange(1 << b)
        #: full-adder LUT pair: sum digit + carry from one rotation
        self._tv_add = jnp.asarray(build_tv(
            [_enc_vals(vs & (codec.base - 1), codec),
             _enc_vals(vs >> m, codec)], b, N))
        #: "differs" indicator: t = x + comp(y) == 2^m-1 iff x == y
        self._tv_ne = jnp.asarray(build_tv(
            [_enc_vals((vs != codec.base - 1).astype(np.uint32), codec)],
            b, N))
        #: OR of two {0,1} digits (t = u + v in {0,1,2})
        self._tv_or = jnp.asarray(build_tv(
            [_enc_vals((vs >= 1).astype(np.uint32), codec)], b, N))
        #: bivariate AND of two 1-bit digits (t = u + v == 2)
        self._tv_and2 = jnp.asarray(build_tv(
            [_enc_vals((vs >= 2).astype(np.uint32), codec)], b, N))
        #: scaled select for msg_bits >= 2: t = 2*digit + flag, flag odd ->
        #: the digit, else 0 (t <= 2*base - 1 < 2^b always fits)
        self._tv_sel = jnp.asarray(build_tv(
            [_enc_vals(np.where((vs & 1) == 1, vs >> 1, 0), codec)], b, N))
        #: the select table actually used by _select_digits (m=1 keeps the
        #: unscaled bivariate-AND form: lowest noise, the measured margin)
        self._tv_pick = self._tv_and2 if m == 1 else self._tv_sel
        if m >= 2:
            #: amount-digit -> bits: J=m interleaved LUTs, one rotation
            self._tv_bits = jnp.asarray(build_tv(
                [_enc_vals((vs >> j) & 1, codec) for j in range(m)], b, N))
            #: one-bit left shift: lo=(2v) mod base, hi=top bit (carry up)
            self._tv_sh1l = jnp.asarray(build_tv(
                [_enc_vals((vs << 1) & (codec.base - 1), codec),
                 _enc_vals((vs >> (m - 1)) & 1, codec)], b, N))
            #: one-bit right shift: lo=v>>1, hi=low bit moved to the top
            self._tv_sh1r = jnp.asarray(build_tv(
                [_enc_vals((vs & (codec.base - 1)) >> 1, codec),
                 _enc_vals((vs & 1) << (m - 1), codec)], b, N))
            #: top-bit flip of a clean digit (signed<->unsigned order map)
            self._tv_flip = jnp.asarray(build_tv(
                [_enc_vals((vs ^ (codec.base >> 1)) & (codec.base - 1),
                           codec)], b, N))
        else:
            self._tv_bits = self._tv_sh1l = self._tv_sh1r = self._tv_sel
        if codec.buf_bits >= 2 * m:
            #: bivariate digit product (t = base*x + y): lo/hi digits of
            #: x*y from one rotation — needs 2m bits of phase space
            xv, yv = (vs >> m) & (codec.base - 1), vs & (codec.base - 1)
            self._tv_mul = jnp.asarray(build_tv(
                [_enc_vals((xv * yv) & (codec.base - 1), codec),
                 _enc_vals((xv * yv) >> m, codec)], b, N))
        else:
            self._tv_mul = None

    # -- helpers ---------------------------------------------------------
    def _check(self, *xs: IntCtxt):
        for x in xs[1:]:
            if x.codec != xs[0].codec or x.digits.shape != xs[0].digits.shape:
                raise ValueError("operand codec/shape mismatch")
        if xs[0].codec != self.codec:
            raise ValueError("ciphertext codec differs from context codec")

    def trivial_uint(self, values: Sequence[int], bits: int) -> IntCtxt:
        """Noiseless server-side constants (trivial ciphertexts)."""
        codec = self.codec
        D = codec.digits_for(bits)
        m = codec.msg_bits
        n0 = self.ctx.params.lvl0.dim
        digs = np.array([[(int(v) >> (m * d)) & (codec.base - 1)
                          for d in range(D)] for v in values])
        data = np.zeros((len(values), D, n0 + 1), dtype=np.uint32)
        data[:, :, n0] = _enc_vals(digs, codec)
        return IntCtxt(jnp.asarray(data), codec)

    def _trivial_digit(self, B: int, value: int) -> jnp.ndarray:
        n0 = self.ctx.params.lvl0.dim
        row = np.zeros(n0 + 1, dtype=np.uint32)
        row[n0] = (value * self.codec.delta) % _MOD
        return jnp.broadcast_to(jnp.asarray(row), (B, n0 + 1))

    def _comp_digits(self, y: jnp.ndarray) -> jnp.ndarray:
        """Digitwise (2^m - 1) - v: ciphertext negation + constant — exact,
        noise-preserving (the two's-complement step of sub)."""
        n0 = self.ctx.params.lvl0.dim
        cmax = U32(((self.codec.base - 1) * self.codec.delta) % _MOD)
        out = jnp.negative(y)
        return out.at[..., n0].add(cmax)

    # -- add / sub -------------------------------------------------------
    def _add_prog(self):
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim

        def run(xd, yd, cin, tv, keys):
            xt = jnp.moveaxis(xd, 1, 0)            # [D, B, n0+1]
            yt = jnp.moveaxis(yd, 1, 0)
            # trivial carry-in built ON DEVICE from the scalar: a host-built
            # c0 would be copied to the device on every dispatch
            c0 = jnp.zeros((xd.shape[0], n0 + 1), U32).at[:, n0].set(
                cin * U32(self.codec.delta))

            def body(c, ab):
                a, b_ = ab
                t = a + b_ + c                     # linear: digit sum fits b
                sc = B.pbs_many(t, tv, 2, keys, p, bk, theta=1)
                return sc[1], sc[0]                # carry out, sum digit

            cout, sums = jax.lax.scan(body, c0, (xt, yt))
            return jnp.moveaxis(sums, 0, 1), cout

        return run

    def add_full(self, x: IntCtxt, y: IntCtxt,
                 carry_in: int = 0) -> tuple:
        """Ripple add, ONE dispatch: returns (sum, carry_digit). The carry
        digit is a clean {0,1} digit ciphertext [B, n0+1] (the overflow
        bit; feed to digit_to_bool for the gate domain)."""
        self._check(x, y)
        prog = self.ctx._jit(("int_add", self.codec), self._add_prog(),
                             batch_argnums=(0, 1))
        sums, cout = prog(x.digits, y.digits, U32(carry_in), self._tv_add,
                          self.ctx.keys)
        return IntCtxt(sums, self.codec), cout

    def add(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        """x + y mod 2^bits (wrapping)."""
        return self.add_full(x, y)[0]

    def sub_full(self, x: IntCtxt, y: IntCtxt) -> tuple:
        """x - y via two's complement: (difference, ge_digit) where
        ge_digit is the final carry — a clean {0,1} digit encrypting
        x >= y."""
        self._check(x, y)
        prog = self.ctx._jit(("int_sub", self.codec), self._sub_prog(),
                             batch_argnums=(0, 1))
        sums, cout = prog(x.digits, y.digits, U32(1), self._tv_add,
                          self.ctx.keys)
        return IntCtxt(sums, self.codec), cout

    def _sub_prog(self):
        base = self._add_prog()

        def run(xd, yd, c0, tv, keys):
            return base(xd, self._comp_digits(yd), c0, tv, keys)

        return run

    def sub(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        return self.sub_full(x, y)[0]

    def add_scalar(self, x: IntCtxt, value: int) -> IntCtxt:
        return self.add(x, self.trivial_uint([value] * x.batch, x.bits))

    def sub_scalar(self, x: IntCtxt, value: int) -> IntCtxt:
        return self.sub(x, self.trivial_uint([value] * x.batch, x.bits))

    def neg(self, x: IntCtxt) -> IntCtxt:
        """Two's-complement negation mod 2^bits."""
        return self.sub(self.trivial_uint([0] * x.batch, x.bits), x)

    # -- comparisons -----------------------------------------------------
    def digit_to_bool(self, digit: jnp.ndarray) -> Ctxt:
        """{0,1} digit -> gate-domain bool (phase +-mu0): a pure linear
        rescale, p' = 2^(b-1) * p - mu0 (noise x 2^(b-1))."""
        p = self.ctx.params
        n0 = p.lvl0.dim
        out = digit * U32(1 << (self.codec.buf_bits - 1))
        out = out.at[..., n0].add(U32((-p.lvl0.mu) % _MOD))
        return Ctxt(out, 0)

    def bool_to_digit(self, ct: Ctxt) -> jnp.ndarray:
        """Gate-domain bool -> clean {0,1} digit (one bootstrap: sign LUT
        delta/2, then +delta/2)."""
        p, bk = self.ctx.params, self.ctx.backend
        half = self.codec.delta // 2
        tv = jnp.full((p.lvl1.n,), U32(half))

        def run(c, t, keys):
            out = B.programmable_bootstrap(c, t, keys, p, bk)
            return out.at[:, p.lvl0.dim].add(U32(half))

        prog = self.ctx._jit(("int_frombool", self.codec), run,
                             batch_argnums=(0,))
        return prog(ct.data, tv, self.ctx.keys)

    def ge(self, x: IntCtxt, y: IntCtxt) -> Ctxt:
        """x >= y as a gate-domain bool (cost: one sub)."""
        return self.digit_to_bool(self.sub_full(x, y)[1])

    def lt(self, x: IntCtxt, y: IntCtxt) -> Ctxt:
        out = self.ge(x, y)
        return Ctxt(jnp.negative(out.data), 0)

    def eq(self, x: IntCtxt, y: IntCtxt) -> Ctxt:
        """x == y as a gate-domain bool, ONE dispatch: per-digit "differs"
        indicators (one rotation each, all digits batched) + an OR tree of
        bivariate rotations + a linear NOT."""
        self._check(x, y)
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim
        d = U32(self.codec.delta)

        def run(xd, yd, tv_ne, tv_or, keys):
            Bt, D = xd.shape[0], xd.shape[1]
            t = (xd + self._comp_digits(yd)).reshape(Bt * D, n0 + 1)
            ind = B.pbs_many(t, tv_ne, 1, keys, p, bk,
                             theta=0)[0].reshape(Bt, D, n0 + 1)
            ne = self._or_digits([ind[:, i] for i in range(D)], tv_or, keys)
            eq_digit = jnp.negative(ne).at[:, n0].add(d)   # 1 - v
            return eq_digit

        prog = self.ctx._jit(("int_eq", self.codec, x.ndigits), run,
                             batch_argnums=(0, 1))
        return self.digit_to_bool(prog(x.digits, y.digits, self._tv_ne,
                                       self._tv_or, self.ctx.keys))

    def eq_scalar(self, x: IntCtxt, value: int) -> Ctxt:
        return self.eq(x, self.trivial_uint([value] * x.batch, x.bits))

    # -- select / min / max ----------------------------------------------
    def select(self, cond: Ctxt, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        """cond ? x : y, digitwise: each output digit is
        (s PICK x_d) + (NOT s PICK y_d) — the two rotation sets of EVERY
        digit share one batched dispatch, and the results sum LINEARLY
        (exactly one term is nonzero, so the sum IS the selected value).
        Cost: 2 rotations/digit + 1/word (the cond bridge). For msg_bits=1
        output digit noise is sqrt(2) x fresh (a linear add of two
        bootstrap outputs); the next adder input margin drops
        4.76 -> ~4.3 sigma, fine for chaining. msg_bits>=2 uses the
        scaled pick (t = 2*digit + flag; _select_digits).

        `cond` is a gate-domain bool (Ctxt, phase +-mu) broadcast over all
        digits of each word."""
        self._check(x, y)
        # A gate bool (phase +-mu0) cannot be rescaled DOWN to digit scale
        # linearly (mu0 = 2^29 is not invertible mod 2^32), so one
        # bootstrap bridges cond to a clean {0,1} digit — amortized over
        # every digit of the word. Then both rotation sets of every digit
        # share one batched dispatch and the results sum linearly.
        sdig = self.bool_to_digit(cond)                   # [B, n0+1]

        def run2(sd, xd, yd, tv_pick, keys):
            return self._select_digits(sd, xd, yd, tv_pick, keys)

        prog = self.ctx._jit(("int_select", self.codec), run2,
                             batch_argnums=(0, 1, 2))
        out = prog(sdig, x.digits, y.digits, self._tv_pick, self.ctx.keys)
        return IntCtxt(out, self.codec)

    # -- signed views (two's complement) -----------------------------------
    def _flip_msb(self, x: IntCtxt) -> IntCtxt:
        """Add 2^(bits-1) mod 2^bits: maps signed order onto unsigned
        order. For msg_bits=1 the top digit's bit flip is the linear digit
        complement (negate + constant) — free and exact. For msg_bits>=2
        the top BIT of the top digit flips via one LUT rotation per word
        (v XOR base/2 is not linear on the torus digit encoding)."""
        if self.codec.msg_bits == 1:
            top = self._comp_digits(x.digits[:, -1:])
        else:
            p, bk = self.ctx.params, self.ctx.backend

            def run(td, tv, keys):
                return B.pbs_many(td, tv, 1, keys, p, bk, theta=0)[0]

            prog = self.ctx._jit(("int_flip", self.codec), run,
                                 batch_argnums=(0,))
            top = prog(x.digits[:, -1], self._tv_flip,
                       self.ctx.keys)[:, None, :]
        return IntCtxt(jnp.concatenate([x.digits[:, :-1], top], axis=1),
                       x.codec)

    def ge_signed(self, x: IntCtxt, y: IntCtxt) -> Ctxt:
        """Signed x >= y: flip both MSBs (linear, free) then compare
        unsigned — same cost as ge."""
        return self.ge(self._flip_msb(x), self._flip_msb(y))

    def lt_signed(self, x: IntCtxt, y: IntCtxt) -> Ctxt:
        out = self.ge_signed(x, y)
        return Ctxt(jnp.negative(out.data), 0)

    def min_signed(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        return self.select(self.ge_signed(x, y), y, x)

    def max_signed(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        return self.select(self.ge_signed(x, y), x, y)

    def abs_(self, x: IntCtxt) -> IntCtxt:
        """|x| for signed x (two's complement; |-2^(bits-1)| wraps to
        itself as in hardware): one comparison against zero + one neg +
        one select."""
        zero = self.trivial_uint([0] * x.batch, x.bits)
        return self.select(self.ge_signed(x, zero), x, self.neg(x))

    def min_(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        """Elementwise minimum: one sub (the comparison) + one select."""
        return self.select(self.ge(x, y), y, x)

    def max_(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        """Elementwise maximum: one sub + one select."""
        return self.select(self.ge(x, y), x, y)

    # -- LUTs and structure ----------------------------------------------
    def apply_lut(self, x: IntCtxt, table: Sequence[int]) -> IntCtxt:
        """Digitwise LUT: out_d = table[x_d] (one rotation per digit, all
        digits of the batch in one dispatch)."""
        self._check(x)
        codec = self.codec
        assert len(table) == codec.base
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim
        vs = np.arange(1 << codec.buf_bits)
        outs = _enc_vals(np.asarray(table, dtype=np.uint64)[
            vs % codec.base], codec)
        tv = jnp.asarray(build_tv([outs], codec.buf_bits, p.lvl1.n))

        def run(xd, t, keys):
            Bt, D = xd.shape[0], xd.shape[1]
            flat = xd.reshape(Bt * D, n0 + 1)
            out = B.pbs_many(flat, t, 1, keys, p, bk, theta=0)[0]
            return out.reshape(Bt, D, n0 + 1)

        prog = self.ctx._jit(("int_lut", self.codec), run,
                             batch_argnums=(0,))
        return IntCtxt(prog(x.digits, tv, self.ctx.keys), codec)

    def shift_digits(self, x: IntCtxt, by: int) -> IntCtxt:
        """Shift by whole digits (left = towards high digits); vacated
        digits are trivial zeros. Free (no bootstraps)."""
        B_, D = x.batch, x.ndigits
        zero = self._trivial_digit(B_, 0)[:, None, :]
        if by >= 0:
            pads = jnp.broadcast_to(zero, (B_, min(by, D),
                                           zero.shape[-1]))
            kept = x.digits[:, :max(D - by, 0)]
        else:
            pads = jnp.broadcast_to(zero, (B_, min(-by, D),
                                           zero.shape[-1]))
            kept = x.digits[:, min(-by, D):]
            return IntCtxt(jnp.concatenate([kept, pads], axis=1), x.codec)
        return IntCtxt(jnp.concatenate([pads, kept], axis=1), x.codec)

    def _mul_prog(self, D: int):
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim

        def run(xd, yd, tv_and, tv_add, keys):
            Bt = xd.shape[0]
            acc0 = jnp.zeros((Bt, 2 * D, n0 + 1), U32)  # trivial zeros

            def ripple(acc, add):
                # both [Bt, 2D, n0+1]; fused full-width carry chain
                c0 = jnp.zeros((Bt, n0 + 1), U32)

                def body(c, ab):
                    a, b_ = ab
                    sc = B.pbs_many(a + b_ + c, tv_add, 2, keys, p, bk,
                                    theta=1)
                    return sc[1], sc[0]

                _, sums = jax.lax.scan(
                    body, c0, (jnp.moveaxis(acc, 1, 0),
                               jnp.moveaxis(add, 1, 0)))
                return jnp.moveaxis(sums, 0, 1)

            def row_body(acc, inp):
                yr, r = inp
                t = (xd + yr[:, None, :]).reshape(Bt * D, n0 + 1)
                row = B.pbs_many(t, tv_and, 1, keys, p, bk,
                                 theta=0)[0].reshape(Bt, D, n0 + 1)
                shifted = jax.lax.dynamic_update_slice(
                    jnp.zeros((Bt, 2 * D, n0 + 1), U32), row, (0, r, 0))
                return ripple(acc, shifted), None

            acc, _ = jax.lax.scan(row_body, acc0,
                                  (jnp.moveaxis(yd, 1, 0),
                                   jnp.arange(D)))
            return acc

        return run

    def _mul_prog_multi(self, D: int):
        """Schoolbook product for msg_bits >= 2 (needs buf_bits >= 2m):
        each partial-product row is a bivariate LUT t = base*x_d + y_r
        whose ONE rotation yields both the lo and hi digits of x_d * y_r;
        lo and the digit-shifted hi accumulate through a fused two-addend
        ripple (t = acc + lo + hi + c < 3*base + carry <= 2^b)."""
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim
        base = self.codec.base

        def run(xd, yd, tv_mul, tv_add, keys):
            Bt = xd.shape[0]
            acc0 = jnp.zeros((Bt, 2 * D, n0 + 1), U32)

            def ripple2(acc, add1, add2):
                c0 = jnp.zeros((Bt, n0 + 1), U32)

                def body(c, auv):
                    a, u, v = auv
                    sc = B.pbs_many(a + u + v + c, tv_add, 2, keys, p, bk,
                                    theta=1)
                    return sc[1], sc[0]

                _, sums = jax.lax.scan(
                    body, c0, (jnp.moveaxis(acc, 1, 0),
                               jnp.moveaxis(add1, 1, 0),
                               jnp.moveaxis(add2, 1, 0)))
                return jnp.moveaxis(sums, 0, 1)

            def row_body(acc, inp):
                yr, r = inp
                t = (xd * U32(base) + yr[:, None, :]).reshape(Bt * D,
                                                              n0 + 1)
                lo, hi = B.pbs_many(t, tv_mul, 2, keys, p, bk, theta=1)
                z = jnp.zeros((Bt, 2 * D, n0 + 1), U32)
                lo_sh = jax.lax.dynamic_update_slice(
                    z, lo.reshape(Bt, D, n0 + 1), (0, r, 0))
                hi_sh = jax.lax.dynamic_update_slice(
                    z, hi.reshape(Bt, D, n0 + 1), (0, r + 1, 0))
                return ripple2(acc, lo_sh, hi_sh), None

            acc, _ = jax.lax.scan(row_body, acc0,
                                  (jnp.moveaxis(yd, 1, 0), jnp.arange(D)))
            return acc

        return run

    def _select_digits(self, g, a, b_, tv_pick, keys):
        """Digitwise g ? a : b_ where g is a CLEAN {0,1} digit [B, n0+1]
        (no gate-bool bridge needed) and a/b_ are [B, W, n0+1]. Both
        rotation sets share one pbs_many call; the results sum linearly
        (exactly one term per digit is nonzero).

        msg_bits=1 uses the bivariate-AND form t = digit + flag (lowest
        noise: both fresh); msg_bits>=2 uses the scaled form
        t = 2*digit + flag with the odd-selector LUT (t < 2^b always)."""
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim
        Bt, W = a.shape[0], a.shape[1]
        ns = jnp.negative(g).at[:, n0].add(U32(self.codec.delta))
        if self.codec.msg_bits == 1:
            t1 = (a + g[:, None, :]).reshape(Bt * W, n0 + 1)
            t0 = (b_ + ns[:, None, :]).reshape(Bt * W, n0 + 1)
        else:
            t1 = (a * U32(2) + g[:, None, :]).reshape(Bt * W, n0 + 1)
            t0 = (b_ * U32(2) + ns[:, None, :]).reshape(Bt * W, n0 + 1)
        both = jnp.concatenate([t1, t0], axis=0)
        r = B.pbs_many(both, tv_pick, 1, keys, p, bk, theta=0)[0]
        return (r[:Bt * W] + r[Bt * W:]).reshape(Bt, W, n0 + 1)

    def _or_digits(self, cols, tv_or, keys):
        """OR-tree over clean {0,1} digit ciphertexts [B, n0+1]: each
        round batches every pair's t = u + v rotation into one pbs_many
        call (the eq() OR tree, factored for reuse)."""
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim
        cols = list(cols)
        while len(cols) > 1:
            nxt, pairs = [], []
            for i in range(0, len(cols) - 1, 2):
                pairs.append(cols[i] + cols[i + 1])
            if len(cols) % 2:
                nxt.append(cols[-1])
            if pairs:
                tt = jnp.concatenate(pairs, axis=0)
                ors = B.pbs_many(tt, tv_or, 1, keys, p, bk, theta=0)[0]
                nxt = list(ors.reshape(len(pairs), cols[0].shape[0],
                                       n0 + 1)) + nxt
            cols = nxt
        return cols[0]

    def _div_prog(self, D: int):
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim
        W = D + 1                                  # remainder register width

        def run(r0, xd, yd, tv_add, tv_and, keys):
            Bt = xd.shape[0]
            zero = jnp.zeros((Bt, n0 + 1), U32)
            # divisor zero-extended to W digits; complemented once for the
            # two's-complement trial subtraction of every step
            cyW = self._comp_digits(
                jnp.concatenate([yd, zero[:, None, :]], axis=1))

            def sub_trial(r2):
                # r2 - y = r2 + comp(y) + 1 rippled over W digits; the
                # final carry is the (r2 >= y) indicator.
                c0 = zero.at[:, n0].add(U32(self.codec.delta))

                def body(c, ab):
                    a, b_ = ab
                    sc = B.pbs_many(a + b_ + c, tv_add, 2, keys, p, bk,
                                    theta=1)
                    return sc[1], sc[0]

                ge, diffs = jax.lax.scan(
                    body, c0, (jnp.moveaxis(r2, 1, 0),
                               jnp.moveaxis(cyW, 1, 0)))
                return jnp.moveaxis(diffs, 0, 1), ge

            def step(r, xbit):
                # r2 = 2r + next dividend bit. The dropped top digit is
                # always an encryption of 0 (the loop invariant keeps
                # r < 2^D before the shift).
                r2 = jnp.concatenate([xbit[:, None, :], r[:, :-1]], axis=1)
                diff, ge = sub_trial(r2)
                return self._select_digits(ge, diff, r2, tv_and, keys), ge

            xs_hi_first = jnp.moveaxis(xd, 1, 0)[::-1]
            r, qbits = jax.lax.scan(step, r0, xs_hi_first)
            q = jnp.moveaxis(qbits[::-1], 0, 1)    # back to little-endian
            return q, r                            # full W-wide carry

        return run

    def _ripple_sub(self, minu, comp_sub, tv_add, keys):
        """minu - sub = minu + comp_sub + 1 rippled over the digit axis;
        returns (difference [Bt, W, n0+1], ge carry [Bt, n0+1]) — the
        final carry is the (minu >= sub) indicator."""
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim
        Bt = minu.shape[0]
        c0 = jnp.zeros((Bt, n0 + 1), U32).at[:, n0].add(
            U32(self.codec.delta))

        def body(c, ab):
            a, b_ = ab
            sc = B.pbs_many(a + b_ + c, tv_add, 2, keys, p, bk, theta=1)
            return sc[1], sc[0]

        ge, diffs = jax.lax.scan(body, c0, (jnp.moveaxis(minu, 1, 0),
                                            jnp.moveaxis(comp_sub, 1, 0)))
        return jnp.moveaxis(diffs, 0, 1), ge

    def _div_prog_multi(self, D: int):
        """Restoring division with radix-2^m quotient DIGITS: per step,
        the base-1 multiples j*y (precomputed once with exact homomorphic
        ripple adds) are trial-subtracted from the shifted remainder in
        one batched scan; the quotient digit is the LINEAR sum of the
        monotone ge_j flags, and the next remainder is a one-hot select
        over the base candidates (e_j = ge_j - ge_{j+1} is an exact linear
        {0,1} combination)."""
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim
        base = self.codec.base
        W = D + 1                                  # remainder register

        def run(r0, xd, yd, tv_add, tv_sel, keys):
            Bt = xd.shape[0]
            zero_d = jnp.zeros((Bt, 1, n0 + 1), U32)
            yW = jnp.concatenate([yd, zero_d], axis=1)
            mults = [yW]
            c0 = jnp.zeros((Bt, n0 + 1), U32)
            for _ in range(2, base):               # j*y, exact W-digit adds

                def body(c, ab):
                    a, b_ = ab
                    sc = B.pbs_many(a + b_ + c, tv_add, 2, keys, p, bk,
                                    theta=1)
                    return sc[1], sc[0]

                _, sums = jax.lax.scan(
                    body, c0, (jnp.moveaxis(mults[-1], 1, 0),
                               jnp.moveaxis(yW, 1, 0)))
                mults.append(jnp.moveaxis(sums, 0, 1))
            comp_m = jnp.stack([self._comp_digits(mj) for mj in mults])
            comp_flat = comp_m.reshape((base - 1) * Bt, W, n0 + 1)

            def step(r, xdig):
                r2 = jnp.concatenate([xdig[:, None, :], r[:, :D]], axis=1)
                r2t = jnp.broadcast_to(
                    r2[None], (base - 1, Bt, W, n0 + 1)).reshape(
                        (base - 1) * Bt, W, n0 + 1)
                diffs, ges = self._ripple_sub(r2t, comp_flat, tv_add, keys)
                diffs = diffs.reshape(base - 1, Bt, W, n0 + 1)
                ges = ges.reshape(base - 1, Bt, n0 + 1)
                qd = ges.sum(axis=0)               # linear: value in [0,b)
                one = jnp.zeros((Bt, n0 + 1), U32).at[:, n0].add(
                    U32(self.codec.delta))
                e = ([one - ges[0]]
                     + [ges[j] - ges[j + 1] for j in range(base - 2)]
                     + [ges[base - 2]])
                cands = jnp.concatenate([r2[None], diffs], axis=0)
                es = jnp.stack(e)                  # [base, Bt, n0+1]
                t = (cands * U32(2)
                     + es[:, :, None, :]).reshape(base * Bt * W, n0 + 1)
                terms = B.pbs_many(t, tv_sel, 1, keys, p, bk, theta=0)[0]
                r_next = terms.reshape(base, Bt, W, n0 + 1).sum(axis=0)
                return r_next, qd

            xs_hi_first = jnp.moveaxis(xd, 1, 0)[::-1]
            r, qds = jax.lax.scan(step, r0, xs_hi_first)
            q = jnp.moveaxis(qds[::-1], 0, 1)
            return q, r                            # full W-wide carry

        return run

    def divmod_(self, x: IntCtxt, y: IntCtxt, *,
                segment: int | None = None) -> tuple:
        """Restoring division: returns (x // y, x % y).
        msg_bits=1: per quotient bit, one (D+1)-digit trial subtraction +
        one digitwise select, all inside a lax.scan — ~3*D^2 rotations per
        divide. msg_bits>=2: radix-2^m quotient digits via base-1 batched
        trial subtractions + a one-hot select (_div_prog_multi). Division
        by an encrypted zero follows the restoring-hardware convention:
        quotient = 2^bits - 1, remainder = x.

        `segment` (or env CUFHE_DIV_SEG; 0/None = whole divide in ONE
        dispatch) caps the quotient digits evaluated per device dispatch:
        the remainder register is carried between dispatches, bit-exact
        vs the single-scan program. A 32-bit divide is ~3,100 sequential
        latency-bound rotations in one execution — longer than some
        execution environments allow per dispatch, and a server may prefer
        shorter dispatches for preemption.

        Measured margins (tfhepp_128bit, benchmarks/integers.py
        --div-bits; the margins follow from the bit-exact arithmetic, not
        the device): the trial-sub inputs are noisier than the adder's
        (select-output remainder + comp(y) + carry), dropping the digit
        decision margin from the adder's 4.73-4.76 sigma to a measured
        3.91-3.93 sigma on q/r output digits (noise std 2^25.16;
        predicted ~4.1) — ~1e-4/rotation tail; 0 word errors over 64
        verified 8-bit divmods (batch 32) and 512 verified q/r words of
        32-bit divmod (batch 256, segment=8)."""
        self._check(x, y)

        D = x.ndigits
        W = D + 1
        n0 = self.ctx.params.lvl0.dim
        seg = segment if segment is not None else \
            int(os.environ.get("CUFHE_DIV_SEG", "0"))
        seg = seg or D
        msg1 = self.codec.msg_bits == 1
        maker = self._div_prog if msg1 else self._div_prog_multi
        tv2 = self._tv_and2 if msg1 else self._tv_sel
        r = jnp.zeros((x.digits.shape[0], W, n0 + 1), U32)
        qparts = []
        hi = D
        while hi > 0:
            lo = max(0, hi - seg)
            prog = self.ctx._jit(("int_div", self.codec, D, hi - lo),
                                 maker(D), batch_argnums=(0, 1, 2))
            qc, r = prog(r, x.digits[:, lo:hi], y.digits, self._tv_add,
                         tv2, self.ctx.keys)
            qparts.append(qc)                  # top chunk first
            hi = lo
        q = qparts[0] if len(qparts) == 1 else \
            jnp.concatenate(qparts[::-1], axis=1)
        return IntCtxt(q, self.codec), IntCtxt(r[:, :D], self.codec)

    def div(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        return self.divmod_(x, y)[0]

    def mod(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        return self.divmod_(x, y)[1]

    def _digit_shift(self, cur, k: int):
        """Shift by k whole digits (static k; vacated digits trivial 0)."""
        Bt, D = cur.shape[0], cur.shape[1]
        n0 = self.ctx.params.lvl0.dim
        if abs(k) >= D:
            return jnp.zeros_like(cur)
        if k > 0:
            pad = jnp.zeros((Bt, k, n0 + 1), U32)
            return jnp.concatenate([pad, cur[:, :D - k]], axis=1)
        if k < 0:
            pad = jnp.zeros((Bt, -k, n0 + 1), U32)
            return jnp.concatenate([cur[:, -k:], pad], axis=1)
        return cur

    def _shift1(self, cur, sign: int, tv_sh1, keys):
        """One-BIT shift within radix-2^m digits (msg_bits >= 2): ONE
        rotation per digit produces (lo, carry) LUT pairs; the result is
        the linear sum lo_d + carry-from-neighbour — clean, since the
        carry fills exactly the bit position the shift vacated (left:
        lo even, carry in bit 0; right: lo < base/2, carry = base/2)."""
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim
        Bt, D = cur.shape[0], cur.shape[1]
        flat = cur.reshape(Bt * D, n0 + 1)
        lo, hi = B.pbs_many(flat, tv_sh1, 2, keys, p, bk, theta=1)
        lo = lo.reshape(Bt, D, n0 + 1)
        hi = hi.reshape(Bt, D, n0 + 1)
        zero = jnp.zeros((Bt, 1, n0 + 1), U32)
        if sign > 0:   # left: result_d = lo_d + topbit(x_{d-1})
            hi_sh = jnp.concatenate([zero, hi[:, :-1]], axis=1)
        else:          # right: result_d = lo_d + lowbit(x_{d+1}) << (m-1)
            hi_sh = jnp.concatenate([hi[:, 1:], zero], axis=1)
        return lo + hi_sh

    def _shift_prog(self, D: int, S: int, sign: int):
        """Barrel shifter over amount BITS. Amount bits with
        2^i >= total-bits cannot change the answer except by saturating to
        zero: they collapse into ONE OR-tree + one final select against
        zeros (~1 rotation/high bit + 2*D once) instead of a full 2*D-
        rotation select per high bit (ADVICE r4). msg_bits>=2 extracts the
        m bits of each amount digit with one J=m rotation, and odd stage
        widths pay sub-digit 1-bit shifts (_shift1)."""
        p, bk = self.ctx.params, self.ctx.backend
        n0 = p.lvl0.dim
        m = self.codec.msg_bits
        total_bits = D * m

        def run(xd, ad, tv_pick, tv_or, tv_bits, tv_sh1, keys):
            Bt = xd.shape[0]
            if m == 1:
                bits = [ad[:, i] for i in range(S)]
            else:
                flat = ad.reshape(Bt * S, n0 + 1)
                outs = B.pbs_many(flat, tv_bits, m, keys, p, bk)
                outs = outs.reshape(m, Bt, S, n0 + 1)
                bits = [outs[j, :, i]              # bit i*m+j, little-endian
                        for i in range(S) for j in range(m)]
            cur = xd
            sat_bits = []
            for i, bit in enumerate(bits):         # unrolled: static count
                if (1 << i) >= total_bits:
                    sat_bits.append(bit)
                    continue
                q, r = divmod(1 << i, m)
                shifted = self._digit_shift(cur, sign * q)
                for _ in range(r):                 # r < m sub-digit steps
                    shifted = self._shift1(shifted, sign, tv_sh1, keys)
                cur = self._select_digits(bit, shifted, cur, tv_pick, keys)
            if sat_bits:
                sat = self._or_digits(sat_bits, tv_or, keys)
                cur = self._select_digits(sat, jnp.zeros_like(cur), cur,
                                          tv_pick, keys)
            return cur

        return run

    def _shift_by(self, x: IntCtxt, amount: IntCtxt, sign: int,
                  tag: str) -> IntCtxt:
        if x.codec != self.codec or amount.codec != self.codec:
            raise ValueError("ciphertext codec differs from context codec")
        if amount.batch != x.batch:
            raise ValueError("shift amount batch differs from operand batch")
        D, S = x.ndigits, amount.ndigits
        prog = self.ctx._jit((tag, self.codec, D, S),
                             self._shift_prog(D, S, sign),
                             batch_argnums=(0, 1))
        tv_sh1 = self._tv_sh1l if sign > 0 else self._tv_sh1r
        out = prog(x.digits, amount.digits, self._tv_pick, self._tv_or,
                   self._tv_bits, tv_sh1, self.ctx.keys)
        return IntCtxt(out, self.codec)

    def shift_left(self, x: IntCtxt, amount: IntCtxt) -> IntCtxt:
        """x << amount with an ENCRYPTED shift amount: a barrel shifter of
        amount.ndigits stages (stage i selects between x and the static
        2^i-digit shift under bit i of the amount), ONE dispatch,
        2*D rotations per stage. Amounts >= bits yield 0 (bits shifted
        past the top are dropped, vacated digits are trivial zeros)."""
        return self._shift_by(x, amount, +1, "int_shl")

    def shift_right(self, x: IntCtxt, amount: IntCtxt) -> IntCtxt:
        """Logical x >> amount with an ENCRYPTED amount (see shift_left)."""
        return self._shift_by(x, amount, -1, "int_shr")

    def mul(self, x: IntCtxt, y: IntCtxt) -> IntCtxt:
        """Schoolbook product (full 2*bits width), ONE dispatch: the whole
        product — partial-product rows as bivariate rotations, accumulated
        with fused ripple adds — runs as a lax.scan over rows inside one
        compiled program: ~3*D^2 rotations per product (vs ~6*D^2 gate
        bootstraps for the netlist multiplier) and one dispatch instead of
        2*D. msg_bits>=2 needs a codec with buf_bits >= 2*msg_bits (phase
        space for the bivariate digit product, ~2*D^2 rotations), e.g.
        IntCodec(msg_bits=2, buf_bits=4) — the TFHE-rs-style
        message/carry split."""
        self._check(x, y)
        D = x.ndigits
        if self.codec.msg_bits == 1:
            prog = self.ctx._jit(("int_mul", self.codec, D),
                                 self._mul_prog(D), batch_argnums=(0, 1))
            acc = prog(x.digits, y.digits, self._tv_and2, self._tv_add,
                       self.ctx.keys)
        else:
            if self._tv_mul is None:
                raise ValueError(
                    f"mul at msg_bits={self.codec.msg_bits} needs "
                    f"buf_bits >= {2 * self.codec.msg_bits} (bivariate "
                    f"digit-product phase space); use e.g. IntCodec("
                    f"msg_bits={self.codec.msg_bits}, "
                    f"buf_bits={2 * self.codec.msg_bits})")
            prog = self.ctx._jit(("int_mul", self.codec, D),
                                 self._mul_prog_multi(D),
                                 batch_argnums=(0, 1))
            acc = prog(x.digits, y.digits, self._tv_mul, self._tv_add,
                       self.ctx.keys)
        return IntCtxt(acc, self.codec)
