"""Negacyclic NTT over the RAINTT prime — the reference's NTT layer, kept as
the "ntt" gate backend and for host-side key prep.

The reference's hot path is a shared-memory prime-field NTT
(include/ntt_gpu/*: 60-bit GPU-NTT default, 29-bit RAINTT small-modulus
variant, legacy Goldilocks). The production external product here is the
exact int8 limb product instead (ops/poly.py): it is bit-identical to the
golden model, while this small-modulus path adds ~2^12-scale
discretization noise, and on the H100 it also ran faster at batch 4096
(PERF.md).

This module implements the reference's *small-modulus* instantiation
(impl B, ntt_small_modulus.cuh) in plain JAX, because it is part of the
component inventory and is independently useful for host-side key prep
and cross-checking:

  * p = 655360001 = 625 * 2^20 + 1  (ntt_small_modulus.cuh:30),
    values fit u32, 2N | p-1 up to N = 2^19.
  * psi-twisted negacyclic forward (CT) / inverse (GS) transforms,
    vectorized over leading batch axes, jit-compatible on any JAX device:
    all arithmetic is u32 with 16-bit-split mulhi and Shoup multiplication
    by precomputed twiddles (Harvey butterflies) — no u64 anywhere.
  * torus <-> mod-p discretization switching, round(a*P/2^32) and
    round(x*2^32/P) (ntt_small_modulus.cuh:40-73, 151-179).

Generator search mirrors the reference host code (ntt_small_modulus.cu:
74-118): trial g with g^((P-1)/2) != 1 and g^((P-1)/5) != 1, then
psi = g^((P-1)/2N).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: RAINTT prime (reference ntt_small_modulus.cuh:30): 625 * 2^20 + 1.
P = 655360001

U32 = jnp.uint32


# ---------------------------------------------------------------------------
# Host-side table generation (NumPy, exact)
# ---------------------------------------------------------------------------
def _find_generator(p: int = P) -> int:
    """Smallest generator of Z_p^* (p - 1 = 2^20 * 5^4)."""
    for g in range(2, 1000):
        if pow(g, (p - 1) // 2, p) != 1 and pow(g, (p - 1) // 5, p) != 1:
            return g
    raise RuntimeError("no generator found")


def _bit_reverse(x: np.ndarray) -> np.ndarray:
    n = len(x)
    bits = n.bit_length() - 1
    idx = np.array([int(f"{i:0{bits}b}"[::-1], 2) for i in range(n)])
    return x[idx]


@functools.lru_cache(maxsize=None)
def make_tables(nbit: int, p: int = P):
    """Twiddle tables for negacyclic NTT of length N = 2^nbit.

    Returns a dict of uint32 arrays: psi_rev / ipsi_rev (bit-reversed powers
    of the 2N-th root and its inverse) with their Shoup precomputations
    (floor(w * 2^32 / p)), plus n_inv and its Shoup companion.
    """
    N = 1 << nbit
    assert (p - 1) % (2 * N) == 0, "2N must divide p-1"
    g = _find_generator(p)
    psi = pow(g, (p - 1) // (2 * N), p)
    psi_pows = np.array([pow(psi, i, p) for i in range(N)], dtype=np.uint64)
    ipsi = pow(psi, p - 2, p)
    ipsi_pows = np.array([pow(ipsi, i, p) for i in range(N)], dtype=np.uint64)
    psi_rev = _bit_reverse(psi_pows)
    ipsi_rev = _bit_reverse(ipsi_pows)
    n_inv = pow(N, p - 2, p)
    shoup = lambda w: ((w.astype(np.object_) << 32) // p).astype(np.uint64)
    return {
        "psi_rev": psi_rev.astype(np.uint32),
        "psi_rev_shoup": shoup(psi_rev).astype(np.uint32),
        "ipsi_rev": ipsi_rev.astype(np.uint32),
        "ipsi_rev_shoup": shoup(ipsi_rev).astype(np.uint32),
        "n_inv": np.uint32(n_inv),
        "n_inv_shoup": np.uint32((n_inv << 32) // p),
    }


# ---------------------------------------------------------------------------
# u32 modular primitives (jit-compatible, no u64)
# ---------------------------------------------------------------------------
def _mulhi_u32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """High 32 bits of the 64-bit product, via 16-bit splits."""
    a0, a1 = a & U32(0xFFFF), a >> U32(16)
    b0, b1 = b & U32(0xFFFF), b >> U32(16)
    mid = a1 * b0 + ((a0 * b0) >> U32(16))          # < 2^32
    mid2 = a0 * b1 + (mid & U32(0xFFFF))            # < 2^32
    return a1 * b1 + (mid >> U32(16)) + (mid2 >> U32(16))


def mulmod_shoup(x: jnp.ndarray, w: jnp.ndarray,
                 w_shoup: jnp.ndarray, p: int = P) -> jnp.ndarray:
    """x * w mod p with w constant and w_shoup = floor(w * 2^32 / p)
    (Harvey/Shoup multiplication; exact for x < p)."""
    q = _mulhi_u32(w_shoup, x)
    r = w * x - q * U32(p)                           # mod 2^32; r in [0, 2p)
    return jnp.where(r >= U32(p), r - U32(p), r)


def addmod(a, b, p: int = P):
    s = a + b
    return jnp.where(s >= U32(p), s - U32(p), s)


def submod(a, b, p: int = P):
    return jnp.where(a >= b, a - b, a + U32(p) - b)


def torus_to_mod(a: jnp.ndarray, p: int = P) -> jnp.ndarray:
    """round(a * p / 2^32) mod p — torus32_to_ntt_mod
    (ntt_small_modulus.cuh:40-56)."""
    lo = a * U32(p)
    hi = _mulhi_u32(a, U32(p))
    r = hi + (lo >> U32(31))                         # + carry of lo + 2^31
    return jnp.where(r >= U32(p), r - U32(p), r)


def mod_to_torus(x: np.ndarray, p: int = P) -> np.ndarray:
    """round(x * 2^32 / p) mod 2^32 — ntt_mod_to_torus32
    (ntt_small_modulus.cuh:58-73). Host-side (NumPy u64) exact form."""
    x = np.asarray(x, dtype=np.uint64)
    return (((x << 32) + p // 2) // p).astype(np.uint32)


def mod_to_torus_jax(x: jnp.ndarray, p: int = P) -> jnp.ndarray:
    """Device mod_to_torus: x * floor(2^64/p) >> 32 in u32 arithmetic.

    |error| <= 2 torus LSB vs the exact rounding division — orders of
    magnitude below the path's inherent 2^32/p discretization noise (the
    'WithModSwitch' conversions of ntt_small_modulus.cuh:151-179 carry the
    same quantization class)."""
    inv = (1 << 64) // p                            # 35-bit constant
    hi, lo = np.uint32(inv >> 32), np.uint32(inv & 0xFFFFFFFF)
    return x * U32(hi) + _mulhi_u32(x, U32(lo))


def torus_to_mod_host(a: np.ndarray, p: int = P) -> np.ndarray:
    """Exact host-side torus32_to_ntt_mod: round(a * p / 2^32) mod p."""
    q = ((np.asarray(a, dtype=np.uint64) * p + (1 << 31)) >> 32)
    return np.where(q >= p, q - p, q).astype(np.uint32)


def ntt_forward_host(a: np.ndarray, tables: dict, p: int = P) -> np.ndarray:
    """NumPy u64 forward negacyclic NTT (same CT structure as ntt_forward):
    one-time key preparation for the 'ntt' gate backend — the analogue of
    __TRGSW2NTT__ at Initialize() (bootstrap_gpu.cu:111-143)."""
    a = np.asarray(a, dtype=np.uint64) % p
    N = a.shape[-1]
    psi = tables["psi_rev"].astype(np.uint64)
    lead = a.shape[:-1]
    t, m = N, 1
    while m < N:
        t //= 2
        x = a.reshape(lead + (m, 2, t))
        w = psi[m:2 * m].reshape((1,) * len(lead) + (m, 1))
        u, v = x[..., 0, :], (x[..., 1, :] * w) % p
        a = np.stack([(u + v) % p, (u + p - v) % p],
                     axis=-2).reshape(lead + (N,))
        m *= 2
    return a.astype(np.uint32)


# ---------------------------------------------------------------------------
# Transforms (vectorized over leading axes; jit-compatible)
# ---------------------------------------------------------------------------
def ntt_forward(a: jnp.ndarray, tables: dict, p: int = P) -> jnp.ndarray:
    """Negacyclic forward NTT, natural order in -> bit-reversed order out.
    a: [..., N] uint32 with values < p. Cooley-Tukey with the psi-twist
    folded into the twiddles (the reference's SmallForwardNTT structure,
    ntt_small_modulus.cuh:201-301, vectorized instead of thread-parallel).
    """
    N = a.shape[-1]
    psi = jnp.asarray(tables["psi_rev"])
    psi_s = jnp.asarray(tables["psi_rev_shoup"])
    lead = a.shape[:-1]
    t = N
    m = 1
    while m < N:
        t //= 2
        x = a.reshape(lead + (m, 2, t))
        w = psi[m:2 * m].reshape((1,) * len(lead) + (m, 1))
        ws = psi_s[m:2 * m].reshape((1,) * len(lead) + (m, 1))
        u, v = x[..., 0, :], mulmod_shoup(x[..., 1, :], w, ws, p)
        a = jnp.stack([addmod(u, v, p), submod(u, v, p)],
                      axis=-2).reshape(lead + (N,))
        m *= 2
    return a


def ntt_inverse(a: jnp.ndarray, tables: dict, p: int = P) -> jnp.ndarray:
    """Inverse negacyclic NTT, bit-reversed in -> natural order out
    (Gentleman-Sande; reference ntt_small_modulus.cuh inverse path)."""
    N = a.shape[-1]
    ipsi = jnp.asarray(tables["ipsi_rev"])
    ipsi_s = jnp.asarray(tables["ipsi_rev_shoup"])
    lead = a.shape[:-1]
    t = 1
    m = N
    while m > 1:
        m //= 2
        x = a.reshape(lead + (m, 2, t))
        w = ipsi[m:2 * m].reshape((1,) * len(lead) + (m, 1))
        ws = ipsi_s[m:2 * m].reshape((1,) * len(lead) + (m, 1))
        u, v = x[..., 0, :], x[..., 1, :]
        a = jnp.stack([addmod(u, v, p),
                       mulmod_shoup(submod(u, v, p), w, ws, p)],
                      axis=-2).reshape(lead + (N,))
        t *= 2
    return mulmod_shoup(a, U32(tables["n_inv"]),
                        U32(tables["n_inv_shoup"]), p)


def pointwise_mul(a_ntt: jnp.ndarray, b_ntt: jnp.ndarray,
                  b_shoup: jnp.ndarray, p: int = P) -> jnp.ndarray:
    """Pointwise a * b mod p where b carries a Shoup precomputation —
    the NTT-domain MAC shape: in FHE use the key side is precomputed, so
    Shoup multiplication applies (reference bk_ntts are precomputed too,
    bootstrap_gpu.cu:111-143)."""
    return mulmod_shoup(a_ntt, b_ntt, b_shoup, p)


def shoup_precompute(b: np.ndarray, p: int = P) -> np.ndarray:
    """floor(b * 2^32 / p) for host-precomputed operands (u64 host math)."""
    return ((np.asarray(b, dtype=np.uint64) << 32) // p).astype(np.uint32)


def negacyclic_mul_mod_p(a: jnp.ndarray, b_ntt: jnp.ndarray,
                         b_shoup: jnp.ndarray, tables: dict,
                         p: int = P) -> jnp.ndarray:
    """Full fwd -> pointwise -> inv pipeline: negacyclic a*b mod p, with b
    already in NTT form (the reference test_polynomial_mult_1024 pipeline).
    """
    return ntt_inverse(pointwise_mul(ntt_forward(a, tables, p), b_ntt,
                                     b_shoup, p), tables, p)
