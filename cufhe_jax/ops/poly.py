"""Batched polynomial ops over Z_{2^32}[X]/(X^N+1) — the JAX replacement for
the reference NTT layer (include/ntt_gpu/*) and the rotate/decompose device
code (include/gatebootstrapping_gpu.cuh).

Everything is batch-first: a batch of B independent gates replaces the
reference's one-CUDA-block-per-gate model (SURVEY.md §2 parallelism table).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..params import TrlweParams
from .limbs import LIMB_BITS, NLIMBS, decomp_digit_limb_plan

U32 = jnp.uint32


# ---------------------------------------------------------------------------
# Test vector and negacyclic monomial rotation
# ---------------------------------------------------------------------------

def batched_test_vector(bar: jnp.ndarray, mu: int, p: TrlweParams) -> jnp.ndarray:
    """RotatedTestVector (gatebootstrapping_gpu.cuh:29-52), batched.

    bar: [B] uint32 in [1, 2N]. Returns acc [B, k+1, N] uint32 with a=0 and
    b = mu * X^(2N - bar)... i.e. the rotated constant-mu test polynomial.
    Masking (bar >> nbit) to its low bit makes the reference's bar == 2N
    special case fall out of the general formula.
    """
    N = p.n
    B = bar.shape[0]
    i = jnp.arange(N, dtype=U32)[None, :]
    neg = (i < (bar[:, None] & U32(N - 1))) ^ (
        ((bar[:, None] >> U32(p.nbit)) & U32(1)).astype(bool))
    mu_u = U32(mu % (1 << 32))
    b = jnp.where(neg, jnp.negative(mu_u), mu_u)
    acc = jnp.zeros((B, p.k + 1, N), dtype=U32)
    return acc.at[:, p.k, :].set(b)


def rotate_by_xai(acc: jnp.ndarray, a_bar: jnp.ndarray,
                  p: TrlweParams) -> jnp.ndarray:
    """acc * X^a_bar negacyclically, batched over B and all k+1 components
    (the gather+sign in Accumulate, gatebootstrapping_gpu.cuh:162-168).

    acc: [B, k+1, N] uint32; a_bar: [B] uint32 in [0, 2N).

    Implemented as a barrel shifter: nbit conditional static rolls along the
    coefficient axis plus one sign select — static rolls + selects are plain
    elementwise work that XLA fuses, where a per-batch dynamic gather is not.
    """
    N = p.n
    x = acc
    for kbit in range(p.nbit):
        bit = ((a_bar >> U32(kbit)) & U32(1)).astype(bool)[:, None, None]
        x = jnp.where(bit, jnp.roll(x, 1 << kbit, axis=-1), x)
    i = jnp.arange(N, dtype=U32)[None, None, :]
    neg = (i < (a_bar[:, None, None] & U32(N - 1))) ^ (
        ((a_bar[:, None, None] >> U32(p.nbit)) & U32(1)).astype(bool))
    return jnp.where(neg, jnp.negative(x), x)


# ---------------------------------------------------------------------------
# Gadget decomposition
# ---------------------------------------------------------------------------

def decompose(temp: jnp.ndarray, p: TrlweParams) -> jnp.ndarray:
    """Signed gadget decomposition of [B, k+1, N] uint32 (already offset by
    decomp_offset + roundoffset) -> [B, (k+1)*l, N] int32 centered digits in
    [-Bg/2, Bg/2)  (gatebootstrapping_gpu.cuh:171-178)."""
    mask = U32((1 << p.Bgbit) - 1)
    half = jnp.int32(1 << (p.Bgbit - 1))
    digs = []
    for d in range(p.l):
        sh = U32(32 - (d + 1) * p.Bgbit)
        digs.append(((temp >> sh) & mask).astype(jnp.int32) - half)
    # [B, k+1, l, N] -> [B, (k+1)*l, N], row index j*l + d (reference BK
    # row-major layout, gatebootstrapping_gpu.cuh:207)
    out = jnp.stack(digs, axis=2)
    B, kp1, l, N = out.shape
    return out.reshape(B, kp1 * l, N)


def decompose_rotate_sub(acc: jnp.ndarray, a_bar: jnp.ndarray,
                         p: TrlweParams) -> jnp.ndarray:
    """decompose(acc*(X^a_bar - 1) + offsets): [B, (k+1)l, N] int32."""
    off = U32((p.decomp_offset + p.decomp_roundoffset) % (1 << 32))
    temp = rotate_by_xai(acc, a_bar, p) - acc + off
    return decompose(temp, p)


def split_decomp_digits(dec: jnp.ndarray, Bgbit: int):
    """Split centered digits into int8-safe balanced limbs.

    Returns (list of int8 arrays [same shape], limb_bits). For Bgbit <= 8 this
    is a single cast; for large bases (Bg=1024) two balanced limbs.
    """
    nd, bits = decomp_digit_limb_plan(Bgbit)
    if nd == 1:
        return [dec.astype(jnp.int8)], bits
    base = 1 << bits
    half = base >> 1
    out = []
    v = dec
    for _ in range(nd):
        d = ((v + half) & (base - 1)) - half
        out.append(d.astype(jnp.int8))
        v = (v - d) >> bits
    return out, bits


# ---------------------------------------------------------------------------
# Exact negacyclic convolution backends
# ---------------------------------------------------------------------------

def _fold_negacyclic(lin: jnp.ndarray, N: int) -> jnp.ndarray:
    """[..., 2N-1] linear conv -> [..., N] negacyclic (wrap with sign)."""
    lo = lin[..., :N]
    hi = lin[..., N:]
    hi = jnp.pad(hi, [(0, 0)] * (lin.ndim - 1) + [(0, 1)])
    return lo - hi


def negacyclic_conv_i8(dec8: jnp.ndarray, filt: jnp.ndarray,
                       k: int) -> jnp.ndarray:
    """Exact negacyclic convolution via XLA integer convolution.

    dec8: [B, I, N] int8 decomposed polynomials (I = (k+1)*l channels).
    filt: [O, I, N] int8 *reversed* key limb filters, O = (k+1)*NLIMBS,
          o-major: filt[o*NLIMBS + limb].
    Returns [B, k+1, N] uint32 = sum over I of dec ⊛ key (mod 2^32).

    The implicit-GEMM sliding window replaces both the reference's forward
    NTT + pointwise MAC + inverse NTT (gatebootstrapping_gpu.cuh:184-284):
    contraction depth I*N, zero Toeplitz materialization. XLA's GPU compiler
    refuses this int8 -> int32 convolution (cuDNN integer convolutions must
    output s8 or f32), so it runs on the CPU only; see PERF.md.
    """
    N = dec8.shape[-1]
    lin = lax.conv_general_dilated(
        dec8, filt, window_strides=(1,), padding=[(N - 1, N - 1)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.int32)        # [B, O, 2N-1]
    c = _fold_negacyclic(lin, N)                  # [B, O, N] int32
    B = c.shape[0]
    c = c.reshape(B, k + 1, NLIMBS, N).astype(U32)
    out = c[:, :, 0, :]
    for l in range(1, NLIMBS):
        out = out + (c[:, :, l, :] << U32(LIMB_BITS * l))
    return out


def negacyclic_conv_toeplitz(dec8: jnp.ndarray, bk_limbs: jnp.ndarray,
                             k: int) -> jnp.ndarray:
    """Materialize the negacyclic Toeplitz operator and use int8 dot_general
    (cuBLAS int8 GEMMs on the GPU) — the "auto" path.

    dec8: [B, I, N] int8; bk_limbs: [NLIMBS, I, k+1, N] int8 (natural order).
    """
    N = dec8.shape[-1]
    I = dec8.shape[1]
    B = dec8.shape[0]
    r = jnp.arange(N)
    idx = jnp.mod(r[None, :] - r[:, None], N)          # [row, col]
    pos = (r[None, :] >= r[:, None])                    # col >= row: + wrap
    # T[limb, i, o, row, col] = ±bk[limb, i, o, (col-row) mod N]; the sign is
    # applied by splitting into masked positive/negative parts and subtracting
    # in int32 (negating the int8 limb -128 would overflow).
    gath = bk_limbs[..., idx]                           # [L, I, k+1, N, N]
    zero = jnp.int8(0)
    Tp = jnp.where(pos, gath, zero)
    Tn = jnp.where(pos, zero, gath)

    def _flat(T):
        T = jnp.moveaxis(T, 1, 2)                       # [L, k+1, I, N, N]
        return T.reshape(NLIMBS, k + 1, I * N, N)

    Tp, Tn = _flat(Tp), _flat(Tn)
    lhs = dec8.reshape(B, I * N)
    out = jnp.zeros((B, k + 1, N), dtype=U32)
    dims = (((1,), (1,)), ((), ()))
    for l in range(NLIMBS):
        prod = (lax.dot_general(lhs, Tp[l], dims,
                                preferred_element_type=jnp.int32)
                - lax.dot_general(lhs, Tn[l], dims,
                                  preferred_element_type=jnp.int32))
        out = out + (prod.astype(U32) << U32(LIMB_BITS * l))
    return out


# ---------------------------------------------------------------------------
# Sample extraction
# ---------------------------------------------------------------------------

def sample_extract_index0(acc: jnp.ndarray, p: TrlweParams) -> jnp.ndarray:
    """__SampleExtractIndex__<P,0> (bootstrap_gpu.cu:366-381), batched.

    acc: [B, k+1, N] -> [B, k*N + 1] uint32.
    """
    B, _, N = acc.shape
    a = acc[:, :p.k, :]
    ext = jnp.concatenate(
        [a[:, :, :1], jnp.negative(a[:, :, :0:-1])], axis=2)
    return jnp.concatenate(
        [ext.reshape(B, p.k * N), acc[:, p.k, :1]], axis=1)


def sample_extract_for_ks(acc: jnp.ndarray, p: TrlweParams) -> jnp.ndarray:
    """Sample extraction in *KS-input form*: elementwise only, no reverse.

    The true extraction (above) reverses the mask lanes — a negacyclic
    permutation XLA lowers to slow lane shuffles. But a key switch contracts
    over exactly that coefficient axis, so the permutation moves into the
    KSK rows at key-preparation time (prepare_keys builds ksk_limbs_sei);
    the device keeps only the sign select:

        c[j, 0] = a[j, 0],  c[j, i] = -a[j, i]  (i >= 1)

    key_switch(sample_extract_for_ks(acc), ksk_limbs_sei) is bit-identical
    to key_switch(sample_extract_index0(acc), ksk_limbs).
    """
    B, _, N = acc.shape
    a = acc[:, :p.k, :]
    i = jnp.arange(N, dtype=U32)[None, None, :]
    c = jnp.where(i == U32(0), a, jnp.negative(a))
    return jnp.concatenate(
        [c.reshape(B, p.k * N), acc[:, p.k, :1]], axis=1)
