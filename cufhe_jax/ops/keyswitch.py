"""Identity key switch as a signed-one-hot x KSK matmul.

The reference's per-digit KSK gather (keyswitch_gpu.cuh:60-75) becomes a
matrix product: each decomposed digit selects a row of the limb-encoded KSK
via a {-1, 0, +1} coefficient matrix, so the whole key switch is NLIMBS
matmuls (SURVEY.md §7 "keyswitch without gathers"). Exact: all
arithmetic is integer and the coefficient magnitudes keep partial sums far
below 2^31.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..params import GateParams
from .limbs import LIMB_BITS, NLIMBS

U32 = jnp.uint32


def ks_decompose_coeffs(a_in: jnp.ndarray, params: GateParams) -> jnp.ndarray:
    """[B, d1] uint32 -> [B, t*numbase*d1] bfloat16 selection coefficients.

    Digit val in [-halfbase, halfbase); val = +(m+1) selects row m with -1,
    val = -(m+1) selects row m with +1 (the subtract-for-positive convention,
    keyswitch_gpu.cuh:72-73).

    Contraction-axis order is (dig, m, j)-major — whole [B, d1] blocks
    concatenated along lanes. The natural (j, dig, m) order interleaves the
    t*numbase planes at lane granularity, which XLA lowers to cross-lane
    shuffles of the full [B, K] matrix (measured 32 ms of a 34 ms key
    switch at B=4096); block order makes the assembly a free concatenation.
    prepare_keys lays the KSK rows out to match.
    """
    kp = params.ks
    mask = U32((1 << kp.basebit) - 1)
    halfbase = jnp.int32(1 << (kp.basebit - 1))
    off = U32((kp.decomp_offset + kp.roundoffset) % (1 << 32))
    tmp = a_in + off
    blocks = []
    for dig in range(kp.t):
        sh = U32(32 - (dig + 1) * kp.basebit)
        val = ((tmp >> sh) & mask).astype(jnp.int32) - halfbase  # [B, d1]
        for m in range(kp.numbase):
            blocks.append((val == -(m + 1)).astype(jnp.bfloat16)
                          - (val == (m + 1)).astype(jnp.bfloat16))
    return jnp.concatenate(blocks, axis=1)           # [B, t*nb*d1]


def key_switch(tlwe1: jnp.ndarray, ksk_limbs: jnp.ndarray,
               params: GateParams, pre=None) -> jnp.ndarray:
    """KeySwitchFromTLWE / IdentityKeySwitchPreAdd (keyswitch_gpu.cuh:83-188),
    batched. tlwe1: [B, d1+1] uint32; pre = (ca, cb, offset, other) fuses the
    gate linear combination. Returns [B, n0+1] uint32."""
    d1 = params.lvl1.k * params.lvl1.n
    n0 = params.lvl0.dim
    if pre is not None:
        ca_u, cb_u, off_u, other = pre   # u32 scalars (traced or concrete)
        comb = ca_u * tlwe1 + cb_u * other
        a_in = comb[:, :d1]
        b_in = comb[:, d1] + off_u
    else:
        a_in = tlwe1[:, :d1]
        b_in = tlwe1[:, d1]

    co = ks_decompose_coeffs(a_in, params)            # [B, K] bf16
    # bf16 x bf16 -> f32 dots (the KSK is limb-encoded straight to bf16 at
    # key prep; both operands are bf16, so TF32 never applies).
    # EXACT: coefficients are {-1,0,+1} and KSK limbs are int8 values, so
    # every product is an integer of magnitude <= 128 (exactly
    # representable in bf16) and every f32 partial sum is an integer
    # < K*128 <= 2^21 < 2^24 — never rounded.
    assert co.shape[1] * 128 < (1 << 24)
    out = jnp.zeros((co.shape[0], n0 + 1), dtype=U32)
    for l in range(NLIMBS):
        kl = ksk_limbs[l]
        if kl.dtype != jnp.bfloat16:
            kl = kl.astype(jnp.bfloat16)
        prod = lax.dot_general(co, kl, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)
        out = out + (jnp.round(prod).astype(jnp.int32).astype(U32)
                     << U32(LIMB_BITS * l))
    return out.at[:, n0].add(b_in)
