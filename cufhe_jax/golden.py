"""Pure-NumPy golden model of TFHE gate bootstrapping.

This module plays the role the TFHEpp submodule plays for the reference
(params, keygen, encrypt/decrypt, and a CPU implementation of every device
algorithm): it is the bit-exact oracle every device program is tested against.

Each function cites the reference device code it models (file:line under
/root/reference). All torus arithmetic is uint32 with wrap-around; NumPy
array ops on uint32 wrap silently, and intermediate signed work is done in
int64 where products can exceed 32 bits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .params import GateParams, KeySwitchParams, LweParams, TrlweParams
from .rng import RngLike, resolve_rng

U32 = np.uint32
_MOD = 1 << 32


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64).astype(np.uint32)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SecretKey:
    params: GateParams
    lvl0: np.ndarray  # [k0*n0] uint32 in {0,1}
    lvl1: np.ndarray  # [k1, N]  uint32 in {0,1}


def keygen(params: GateParams, seed: Optional[int] = None) -> SecretKey:
    """Secret keygen. Default (seed=None) draws from the OS CSPRNG
    (rng.SecureRandom — the USE_RANDEN analogue, CMakeLists.txt:8); pass a
    seed only for reproducible tests/fixtures."""
    rng = resolve_rng(seed)
    sk0 = rng.integers(0, 2, size=params.lvl0.dim, dtype=np.uint32)
    sk1 = rng.integers(0, 2, size=(params.lvl1.k, params.lvl1.n),
                       dtype=np.uint32)
    return SecretKey(params, sk0, sk1)


def _gaussian_torus(rng: RngLike, alpha: float, shape) -> np.ndarray:
    """Modular-Gaussian torus noise (TFHEpp ModularGaussian convention)."""
    if alpha == 0.0:
        return np.zeros(shape, dtype=np.uint32)
    noise = rng.normal(0.0, alpha, size=shape)
    return np.round(noise * float(_MOD)).astype(np.int64).astype(np.uint32)


# ---------------------------------------------------------------------------
# TLWE (scalar LWE over the uint32 torus)
# ---------------------------------------------------------------------------

def tlwe_encrypt(mu: int, key: np.ndarray, alpha: float,
                 rng: Optional[RngLike] = None) -> np.ndarray:
    """TLWE sample (a_0..a_{d-1}, b) with b = <a,s> + mu + e."""
    rng = resolve_rng(rng=rng)
    d = key.shape[0]
    a = rng.integers(0, _MOD, size=d, dtype=np.uint64).astype(np.uint32)
    b = _u32(np.sum(a.astype(np.int64) * key.astype(np.int64)) + int(mu)
             + int(_gaussian_torus(rng, alpha, ())))
    return np.concatenate([a, np.array([b], dtype=np.uint32)])


def tlwe_encrypt_batch(mus: np.ndarray, key: np.ndarray, alpha: float,
                       rng: Optional[RngLike] = None) -> np.ndarray:
    """Batch TLWE encryption: [B] torus messages -> [B, d+1] samples.

    One RNG draw and one matmul for the whole batch — the client-side
    analogue of the reference's per-gate H2D batching. Bit-compatible with
    per-sample tlwe_encrypt (same distribution; different RNG stream
    consumption order)."""
    rng = resolve_rng(rng=rng)
    mus = np.asarray(mus, dtype=np.uint32)
    d = key.shape[0]
    a = rng.integers(0, _MOD, size=(mus.shape[0], d),
                     dtype=np.uint64).astype(np.uint32)
    e = _gaussian_torus(rng, alpha, mus.shape[0])
    # <a, s> with a < 2^32, s in {0,1}, d <= 2048: fits int64 exactly
    b = _u32(a.astype(np.int64) @ key.astype(np.int64)
             + mus.astype(np.int64) + e.astype(np.int64))
    return np.concatenate([a, b[:, None]], axis=1)


def tlwe_phase(ct: np.ndarray, key: np.ndarray) -> np.uint32:
    d = key.shape[0]
    return _u32(int(ct[d]) - int(np.sum(ct[:d].astype(np.int64)
                                        * key.astype(np.int64))))


def tlwe_decrypt(ct: np.ndarray, key: np.ndarray) -> int:
    """1 if the phase is in the upper half-plane (int32 phase > 0)."""
    return 1 if np.int32(tlwe_phase(ct, key)) > 0 else 0


def encrypt_bit(bit: int, sk: SecretKey, rng: Optional[RngLike] = None,
                level: int = 0) -> np.ndarray:
    """Encrypt one bit as ±mu, the test harness convention (test_util.h:16-23)."""
    rng = resolve_rng(rng=rng)
    p = sk.params
    if level == 0:
        mu = p.lvl0.mu if bit else (-p.lvl0.mu) % _MOD
        return tlwe_encrypt(mu, sk.lvl0, p.lvl0.alpha, rng)
    mu = p.lvl1.mu if bit else (-p.lvl1.mu) % _MOD
    return tlwe_encrypt(mu, sk.lvl1.reshape(-1), p.lvl1.alpha, rng)


def decrypt_bit(ct: np.ndarray, sk: SecretKey, level: int = 0) -> int:
    key = sk.lvl0 if level == 0 else sk.lvl1.reshape(-1)
    return tlwe_decrypt(ct, key)


def encrypt_bit_batch(bits: np.ndarray, sk: SecretKey,
                      rng: Optional[RngLike] = None,
                      level: int = 0) -> np.ndarray:
    """Encrypt a bit array as ±mu in one batch draw: [B, d+1] uint32."""
    rng = resolve_rng(rng=rng)
    p = sk.params
    lp = p.lvl0 if level == 0 else p.lvl1
    key = sk.lvl0 if level == 0 else sk.lvl1.reshape(-1)
    bits = np.asarray(bits).ravel()
    mus = np.where(bits == 1, U32(lp.mu), U32((-lp.mu) % _MOD))
    return tlwe_encrypt_batch(mus, key, lp.alpha, rng)


def decrypt_bit_batch(cts: np.ndarray, sk: SecretKey,
                      level: int = 0) -> np.ndarray:
    """Decrypt [B, d+1] ciphertexts to a bit array in one matmul."""
    key = sk.lvl0 if level == 0 else sk.lvl1.reshape(-1)
    d = key.shape[0]
    cts = np.asarray(cts)
    phase = _u32(cts[:, d].astype(np.int64)
                 - cts[:, :d].astype(np.int64) @ key.astype(np.int64))
    return (phase.astype(np.int32) > 0).astype(np.int64)


# ---------------------------------------------------------------------------
# Polynomial arithmetic in Z_{2^32}[X]/(X^N + 1)
# ---------------------------------------------------------------------------

def negacyclic_polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact negacyclic product; a, b int64-safe arrays of length N.

    Result is int64 of the exact integer negacyclic convolution, NOT reduced
    mod 2^32 (caller reduces). Inputs must be small enough that the exact
    convolution fits int64 (always true here: |a|<=2^32, |b|<=2^32 never both).
    """
    n = a.shape[0]
    full = np.convolve(a.astype(np.int64), b.astype(np.int64))
    out = full[:n].copy()
    out[: n - 1] -= full[n:]
    return out


def _negacyclic_matrix(s: np.ndarray) -> np.ndarray:
    """[N, N] matrix S with (a @ S) = negacyclic_polymul(a, s) for binary s.
    S[u, v] = s[(v-u) mod N] * (-1 if v < u else 1)."""
    n = s.shape[0]
    u = np.arange(n)[:, None]
    v = np.arange(n)[None, :]
    S = s[(v - u) % n].astype(np.int64)
    return np.where(v < u, -S, S)


def _binary_key_polymul_batch(a: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Exact batched negacyclic product a[i] * s for uint32 a, binary s.

    Computed as two float64 BLAS matmuls on 16-bit limbs of `a` (each
    partial sum < 2^16 * N <= 2^26 so float64 is exact), recombined in
    int64 — ~100x faster than np.convolve per row and still bit-exact."""
    S = _negacyclic_matrix(s).astype(np.float64)
    lo = (a & np.uint32(0xFFFF)).astype(np.float64)
    hi = (a >> np.uint32(16)).astype(np.float64)
    return ((hi @ S).astype(np.int64) << 16) + (lo @ S).astype(np.int64)


def trlwe_encrypt_zero_batch(m: int, p: TrlweParams, key: np.ndarray,
                             rng: Optional[RngLike] = None) -> np.ndarray:
    """m TRLWE encryptions of 0 in one draw: [m, k+1, N] uint32."""
    rng = resolve_rng(rng=rng)
    N, k = p.n, p.k
    a = rng.integers(0, _MOD, size=(m, k, N),
                     dtype=np.uint64).astype(np.uint32)
    b = np.zeros((m, N), dtype=np.int64)
    for j in range(k):
        b += _binary_key_polymul_batch(a[:, j], key[j])
    b = _u32(b + _gaussian_torus(rng, p.alpha, (m, N)).astype(np.int64))
    return np.concatenate([a, b[:, None, :].astype(np.uint32)], axis=1)


def trlwe_encrypt_zero(p: TrlweParams, key: np.ndarray,
                       rng: Optional[RngLike] = None) -> np.ndarray:
    """TRLWE encryption of 0: [k+1, N] with b = sum_j a_j*s_j + e."""
    rng = resolve_rng(rng=rng)
    N, k = p.n, p.k
    a = rng.integers(0, _MOD, size=(k, N), dtype=np.uint64).astype(np.uint32)
    b = np.zeros(N, dtype=np.int64)
    for j in range(k):
        b += negacyclic_polymul(a[j].astype(np.int64), key[j].astype(np.int64))
    b = _u32(b + _gaussian_torus(rng, p.alpha, N).astype(np.int64))
    return np.concatenate([a, b[None, :]], axis=0)


def trlwe_encrypt_bits(bits: np.ndarray, p: TrlweParams, key: np.ndarray,
                       rng: Optional[RngLike] = None) -> np.ndarray:
    """TRLWE encryption of N bits packed into slots as ±mu (the message form
    used by the reference CMUX test, test_cmux.cc:82-141)."""
    ct = trlwe_encrypt_zero(p, key, rng)
    msg = np.where(np.asarray(bits) == 1, p.mu, (-p.mu) % _MOD)
    ct[p.k] = _u32(ct[p.k].astype(np.int64) + msg.astype(np.int64))
    return ct


def trlwe_phase(ct: np.ndarray, p: TrlweParams, key: np.ndarray) -> np.ndarray:
    acc = ct[p.k].astype(np.int64).copy()
    for j in range(p.k):
        acc -= negacyclic_polymul(ct[j].astype(np.int64),
                                  key[j].astype(np.int64))
    return _u32(acc)


def trgsw_encrypt(plain: int, p: TrlweParams, key: np.ndarray,
                  rng: Optional[RngLike] = None) -> np.ndarray:
    """TRGSW of a small integer: [(k+1)l, k+1, N].

    Row j*l+d adds plain * 2^(32-(d+1)Bgbit) on component j (the gadget),
    matching TFHEpp's convention used by the BK (bootstrap_gpu.cu:111-143,
    Accumulate MAC layout gatebootstrapping_gpu.cuh:206-222).
    """
    rng = resolve_rng(rng=rng)
    rows = []
    for j in range(p.k + 1):
        for d in range(p.l):
            row = trlwe_encrypt_zero(p, key, rng)
            h = U32((int(plain) * (1 << (32 - (d + 1) * p.Bgbit))) % _MOD)
            row[j, 0] = U32((int(row[j, 0]) + int(h)) % _MOD)
            rows.append(row)
    return np.stack(rows, axis=0)


# ---------------------------------------------------------------------------
# Evaluation keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EvalKey:
    """Server-side keys: raw (non-NTT) BK + KSK, like TFHEpp::EvalKey.

    bk:  [n0, (k+1)l, k+1, N] uint32 — TRGSW(sk0[i]) for each lvl0 coefficient
    ksk: [k1*N, t, numbase, k0*n0+1] uint32 — ksk[j,dig,m] encrypts
         sk1[j]*(m+1)*2^(32-(dig+1)basebit) under sk0 (keyswitch_gpu.cuh:60-75
         indexing; subtract-for-positive-digit convention).
    """
    params: GateParams
    bk: np.ndarray
    ksk: np.ndarray


def make_eval_key(sk: SecretKey, seed: Optional[int] = None) -> EvalKey:
    """Vectorized keygen: all n0*(k+1)*l BK zero-TRLWEs and all d1*t*numbase
    KSK samples are drawn/combined as single batched operations (seconds for
    the 128-bit set vs minutes with per-sample loops). Semantics match the
    scalar trgsw_encrypt/tlwe_encrypt path (same distributions).

    Default (seed=None) draws from the OS CSPRNG; seed only for tests."""
    p = sk.params
    rng = resolve_rng(seed)
    n0 = p.lvl0.dim
    lp = p.lvl1
    k, l, N = lp.k, lp.l, lp.n
    rows = (k + 1) * l

    # BK: bk[i, j*l+d] = TRLWE(0) + sk0[i] * 2^(32-(d+1)Bgbit) on
    # component j, coefficient 0 (trgsw_encrypt gadget convention).
    zeros = trlwe_encrypt_zero_batch(n0 * rows, lp, sk.lvl1, rng)
    bk = zeros.reshape(n0, rows, k + 1, N)
    h = (np.uint64(1) << np.uint64(32) - np.uint64(lp.Bgbit)
         * (np.arange(l, dtype=np.uint64) + 1)).astype(np.uint32)  # [l]
    gad = (sk.lvl0[:, None].astype(np.uint64)
           * h[None, :].astype(np.uint64)).astype(np.uint32)       # [n0, l]
    j_idx = np.repeat(np.arange(k + 1), l)          # component of row j*l+d
    d_idx = np.tile(np.arange(l), k + 1)
    bk[:, np.arange(rows), j_idx, 0] += gad[:, d_idx]

    # KSK: ksk[j, dig, m] = TLWE(dom[j] * (m+1) * 2^(32-(dig+1)basebit)).
    kp = p.ks
    dom = sk.lvl1.reshape(-1)  # extracted-LWE key = lvl1 coefficients in order
    d1 = dom.shape[0]
    shift = (np.uint64(32) - np.uint64(kp.basebit)
             * (np.arange(kp.t, dtype=np.uint64) + 1))
    scale = ((np.arange(kp.numbase, dtype=np.uint64) + 1)[None, :]
             << shift[:, None])                     # [t, numbase] (mod 2^64)
    mus = (dom.astype(np.uint64)[:, None, None]
           * scale[None, :, :]).astype(np.uint32)   # [d1, t, numbase]
    ksk = tlwe_encrypt_batch(mus.reshape(-1), sk.lvl0, p.lvl0.alpha, rng)
    return EvalKey(p, bk, ksk.reshape(d1, kp.t, kp.numbase, n0 + 1))


# ---------------------------------------------------------------------------
# Blind rotation (gatebootstrapping_gpu.cuh)
# ---------------------------------------------------------------------------

def mod_switch_from_torus(phase, nbit: int) -> np.ndarray:
    """modSwitchFromTorus — gatebootstrapping_gpu.cuh:10-16 (no rounding)."""
    return (np.asarray(phase, dtype=np.uint32) >> U32(32 - 1 - nbit)).astype(
        np.uint32)


def rotated_test_vector(p: TrlweParams, bar: int, mu: int) -> np.ndarray:
    """RotatedTestVector — gatebootstrapping_gpu.cuh:29-52. bar in [1, 2N]."""
    N = p.n
    out = np.zeros((p.k + 1, N), dtype=np.uint32)
    mu_u = U32(mu % _MOD)
    neg_mu = U32((-int(mu)) % _MOD)
    if bar == 2 * N:
        out[p.k, :] = mu_u
    else:
        i = np.arange(N)
        neg = (i < (bar & (N - 1))) ^ bool((bar >> p.nbit) & 1)
        out[p.k, :] = np.where(neg, neg_mu, mu_u)
    return out


def _rotate_by_xai(poly: np.ndarray, a_bar: int, p: TrlweParams) -> np.ndarray:
    """poly * X^{a_bar} negacyclically (the gather+sign in Accumulate,
    gatebootstrapping_gpu.cuh:162-168)."""
    N = p.n
    i = np.arange(N)
    src = poly[(i - a_bar) % N]
    neg = (i < (a_bar & (N - 1))) ^ bool((a_bar >> p.nbit) & 1)
    return np.where(neg, _u32(-src.astype(np.int64)), src)


def decompose_rotate_sub(acc: np.ndarray, a_bar: int,
                         p: TrlweParams) -> np.ndarray:
    """(acc * (X^a_bar - 1)) then signed gadget decomposition.

    Returns [(k+1), l, N] int32 digits in [-Bg/2, Bg/2) —
    gatebootstrapping_gpu.cuh:153-181.
    """
    mask = U32((1 << p.Bgbit) - 1)
    half = 1 << (p.Bgbit - 1)
    off = U32((p.decomp_offset + p.decomp_roundoffset) % _MOD)
    out = np.empty((p.k + 1, p.l, acc.shape[1]), dtype=np.int32)
    for j in range(p.k + 1):
        temp = _u32(_rotate_by_xai(acc[j], a_bar, p).astype(np.int64)
                    - acc[j].astype(np.int64) + int(off))
        for d in range(p.l):
            sh = U32(32 - (d + 1) * p.Bgbit)
            out[j, d] = ((temp >> sh) & mask).astype(np.int64).astype(
                np.int32) - half
    return out


def external_product_accumulate(acc: np.ndarray, a_bar: int,
                                trgsw: np.ndarray,
                                p: TrlweParams) -> np.ndarray:
    """One CMUX step: acc += <decomp(acc*(X^a-1)), trgsw>  (Accumulate,
    gatebootstrapping_gpu.cuh:115-285, exact large-modulus semantics)."""
    dec = decompose_rotate_sub(acc, a_bar, p)
    upd = np.zeros((p.k + 1, p.n), dtype=np.int64)
    for j in range(p.k + 1):
        for d in range(p.l):
            row = trgsw[j * p.l + d]
            for o in range(p.k + 1):
                upd[o] += negacyclic_polymul(dec[j, d].astype(np.int64),
                                             row[o].astype(np.int64))
    return _u32(acc.astype(np.int64) + upd)


def blind_rotate(tlwe: np.ndarray, mu: int, ek: EvalKey,
                 pre: Optional[tuple] = None) -> np.ndarray:
    """__BlindRotate__ / __BlindRotatePreAdd__ (gatebootstrapping_gpu.cuh:
    287-345). `tlwe` is a lvl0 ciphertext [n0+1]; if `pre` is given it is
    (ca, cb, offset, tlwe1) and the gate linear combination is fused in.
    Returns the TRLWE accumulator [k+1, N]."""
    p = ek.params
    lp = p.lvl1
    n0 = p.lvl0.dim
    if pre is not None:
        ca, cb, offset, tlwe1 = pre
        comb = _u32(np.int64(ca) * tlwe.astype(np.int64)
                    + np.int64(cb) * tlwe1.astype(np.int64))
        b_in = _u32(int(comb[n0]) + offset)
        a_in = comb[:n0]
    else:
        b_in = tlwe[n0]
        a_in = tlwe[:n0]

    bar = 2 * lp.n - int(mod_switch_from_torus(b_in, lp.nbit))
    acc = rotated_test_vector(lp, bar, mu)
    return _blind_rotate_loop(acc, a_in, ek)


def _blind_rotate_loop(acc: np.ndarray, a_in: np.ndarray,
                       ek: EvalKey) -> np.ndarray:
    """The n0-iteration CMUX accumulator loop from an explicit initial
    accumulator (the rotated test vector)."""
    p = ek.params
    lp = p.lvl1
    roundoffset = 1 << (32 - 2 - lp.nbit)
    for i in range(p.lvl0.dim):
        a_bar = int(mod_switch_from_torus(_u32(int(a_in[i]) + roundoffset),
                                          lp.nbit))
        acc = external_product_accumulate(acc, a_bar, ek.bk[i], lp)
    return acc


def blind_rotate_tv(tlwe: np.ndarray, tv: np.ndarray,
                    ek: EvalKey) -> np.ndarray:
    """Blind rotation with a CUSTOM test polynomial tv [N] uint32 — the
    core of programmable (functional) bootstrapping. The constant-mu gate
    test vector (rotated_test_vector) is the special case tv = mu * 1."""
    p = ek.params
    lp = p.lvl1
    n0 = p.lvl0.dim
    bar = 2 * lp.n - int(mod_switch_from_torus(tlwe[n0], lp.nbit))
    acc = np.zeros((lp.k + 1, lp.n), dtype=np.uint32)
    acc[lp.k] = _rotate_by_xai(np.asarray(tv, dtype=np.uint32),
                               bar & (2 * lp.n - 1), lp)
    return _blind_rotate_loop(acc, tlwe[:n0], ek)


def programmable_bootstrap(tlwe0: np.ndarray, tv: np.ndarray,
                           ek: EvalKey) -> np.ndarray:
    """Custom-test-vector bootstrap -> extract -> keyswitch (lvl0 out).
    Output encrypts tv[w] (or -tv[w - N]) for modswitch phase window w."""
    acc = blind_rotate_tv(tlwe0, tv, ek)
    return key_switch(sample_extract_index0(acc, ek.params.lvl1), ek)


def mod_switch_round(phase, nbit: int, theta: int) -> int:
    """Mod switch rounded to a MULTIPLE of 2^theta windows (the PBSmanyLUT
    rounding, Chillotti-Ligier-Orfila-Tap): the low theta window bits are
    zeroed by round-to-nearest, so a blind rotation lands on a
    2^theta-aligned window and accumulator coefficients j = 0..2^theta-1
    carry tv[w+j] — independent LUT outputs from ONE rotation. theta = 0
    reproduces the reference's rounded a-coefficient switch exactly
    (roundoffset, gatebootstrapping_gpu.cuh:64-66); the reference itself
    has no multi-output bootstrap."""
    sh = 32 - 1 - nbit + theta
    return (((int(phase) + (1 << (sh - 1))) % _MOD) >> sh) << theta


def blind_rotate_tv_many(tlwe: np.ndarray, tv: np.ndarray, ek: EvalKey,
                         theta: int) -> np.ndarray:
    """Blind rotation with a custom test polynomial and the PBSmanyLUT
    mod switch (every switched value — b's window included — rounded to a
    multiple of 2^theta windows). theta=0 differs from blind_rotate_tv
    only in rounding (vs truncating) b's window."""
    p = ek.params
    lp = p.lvl1
    n0 = p.lvl0.dim
    bar = (2 * lp.n - mod_switch_round(tlwe[n0], lp.nbit, theta)) \
        % (2 * lp.n)
    acc = np.zeros((lp.k + 1, lp.n), dtype=np.uint32)
    acc[lp.k] = _rotate_by_xai(np.asarray(tv, dtype=np.uint32), bar, lp)
    for i in range(n0):
        a_bar = mod_switch_round(tlwe[i], lp.nbit, theta)
        acc = external_product_accumulate(acc, a_bar, ek.bk[i], lp)
    return acc


def sample_extract_index(trlwe: np.ndarray, p: TrlweParams,
                         j: int) -> np.ndarray:
    """__SampleExtractIndex__<P, j> for arbitrary j: rotate by X^{-j}
    (= X^{2N-j}) and extract index 0 — exact, and the form the device
    path reuses (the extract-0 permutation is already folded into the
    KSK)."""
    rot = np.stack([_rotate_by_xai(trlwe[c], (2 * p.n - j) % (2 * p.n), p)
                    for c in range(p.k + 1)])
    return sample_extract_index0(rot, p)


def pbs_many(tlwe0: np.ndarray, tv: np.ndarray, J: int, ek: EvalKey,
             theta: Optional[int] = None) -> np.ndarray:
    """Multi-output programmable bootstrap (PBSmanyLUT): ONE blind
    rotation evaluates J interleaved LUTs. With the mod switch rounded to
    2^theta-aligned windows, coefficient j of the accumulator is exactly
    tv[w + j], so J extractions (+ key switches) of the same rotation
    return J independent functions of the input. Returns [J, n0+1]."""
    if theta is None:
        theta = (J - 1).bit_length()
    assert J <= 1 << theta
    acc = blind_rotate_tv_many(tlwe0, tv, ek, theta)
    return np.stack([key_switch(
        sample_extract_index(acc, ek.params.lvl1, j), ek)
        for j in range(J)])


# ---------------------------------------------------------------------------
# Sample extraction + key switch (bootstrap_gpu.cu:366-381, keyswitch_gpu.cuh)
# ---------------------------------------------------------------------------

def sample_extract_index0(trlwe: np.ndarray, p: TrlweParams) -> np.ndarray:
    """__SampleExtractIndex__<P, 0> — bootstrap_gpu.cu:366-381."""
    N, k = p.n, p.k
    out = np.empty(k * N + 1, dtype=np.uint32)
    for kk in range(k):
        a = trlwe[kk]
        ext = np.empty(N, dtype=np.uint32)
        ext[0] = a[0]
        ext[1:] = _u32(-a[N - 1:0:-1].astype(np.int64))
        out[kk * N:(kk + 1) * N] = ext
    out[k * N] = trlwe[k, 0]
    return out


def key_switch(tlwe1: np.ndarray, ek: EvalKey,
               pre: Optional[tuple] = None) -> np.ndarray:
    """KeySwitchFromTLWE / IdentityKeySwitchPreAdd — keyswitch_gpu.cuh:83-188.

    tlwe1: extracted lvl1-domain TLWE [k1*N + 1]; with `pre` = (ca, cb,
    offset, other) the gate linear combination is fused (lvl1-input gates).
    Returns lvl0 TLWE [n0+1].
    """
    p = ek.params
    kp = p.ks
    d1 = p.lvl1.k * p.lvl1.n
    n0 = p.lvl0.dim
    if pre is not None:
        ca, cb, offset, other = pre
        comb = _u32(np.int64(ca) * tlwe1.astype(np.int64)
                    + np.int64(cb) * other.astype(np.int64))
        b_in = _u32(int(comb[d1]) + offset)
        a_in = comb[:d1]
    else:
        b_in = tlwe1[d1]
        a_in = tlwe1[:d1]

    res = np.zeros(n0 + 1, dtype=np.int64)
    res[n0] = int(b_in)  # domain and target are both 32-bit torus
    mask = (1 << kp.basebit) - 1
    halfbase = 1 << (kp.basebit - 1)
    off = (kp.decomp_offset + kp.roundoffset) % _MOD
    tmp = _u32(a_in.astype(np.int64) + off)
    for j in range(d1):
        for dig in range(kp.t):
            val = int((int(tmp[j]) >> (32 - (dig + 1) * kp.basebit)) & mask) \
                - halfbase
            if val > 0:
                res -= ek.ksk[j, dig, val - 1].astype(np.int64)
            elif val < 0:
                res += ek.ksk[j, dig, -val - 1].astype(np.int64)
    return _u32(res)


# ---------------------------------------------------------------------------
# Gates (bootstrap_gpu.cu:424-512 constants; cufhe_gates_gpu.cu wrappers)
# ---------------------------------------------------------------------------

#: gate -> (casign, cbsign, offset-multiplier-of-mu). bootstrap_gpu.cu:430-511.
GATE_CONSTANTS = {
    "nand": (-1, -1, +1),
    "nor": (-1, -1, -1),
    "xnor": (-2, -2, -2),
    "and": (1, 1, -1),
    "or": (1, 1, +1),
    "xor": (2, 2, +2),
    "andny": (-1, 1, -1),
    "andyn": (1, -1, -1),
    "orny": (-1, 1, +1),
    "oryn": (1, -1, +1),
}

#: plaintext truth tables (test/plain.h:10-69)
PLAIN_GATES = {
    "nand": lambda a, b: 1 - (a & b),
    "nor": lambda a, b: 1 - (a | b),
    "xnor": lambda a, b: 1 - (a ^ b),
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "andny": lambda a, b: (1 - a) & b,
    "andyn": lambda a, b: a & (1 - b),
    "orny": lambda a, b: (1 - a) | b,
    "oryn": lambda a, b: a | (1 - b),
    "mux": lambda c, a, b: a if c else b,
    "nmux": lambda c, a, b: 1 - (a if c else b),
    "not": lambda a: 1 - a,
    "copy": lambda a: a,
}


def gate_lvl0(name: str, in0: np.ndarray, in1: np.ndarray,
              ek: EvalKey) -> np.ndarray:
    """Two-input gate on lvl0 ciphertexts: BlindRotatePreAdd → SampleExtract →
    KeySwitch (__HomGate__ br→iks order, bootstrap_gpu.cu:402-421)."""
    p = ek.params
    ca, cb, om = GATE_CONSTANTS[name]
    offset = (om * p.lvl0.mu) % _MOD
    acc = blind_rotate(in0, p.lvl1.mu, ek, pre=(ca, cb, offset, in1))
    tlwe1 = sample_extract_index0(acc, p.lvl1)
    return key_switch(tlwe1, ek)


def gate_lvl1(name: str, in0: np.ndarray, in1: np.ndarray,
              ek: EvalKey) -> np.ndarray:
    """Two-input gate on lvl1 ciphertexts: KeySwitchPreAdd → BlindRotate →
    SampleExtract (__HomGate__ iks→br order, bootstrap_gpu.cu:383-400)."""
    p = ek.params
    ca, cb, om = GATE_CONSTANTS[name]
    offset = (om * p.lvl1.mu) % _MOD
    tlwe0 = key_switch(in0, ek, pre=(ca, cb, offset, in1))
    acc = blind_rotate(tlwe0, p.lvl1.mu, ek)
    return sample_extract_index0(acc, p.lvl1)


def not_gate(ct: np.ndarray) -> np.ndarray:
    """__NotBootstrap__ — negation only, no bootstrap (bootstrap_gpu.cu:692)."""
    return _u32(-ct.astype(np.int64))


def copy_gate(ct: np.ndarray) -> np.ndarray:
    return ct.copy()


def mux_lvl0(inc: np.ndarray, in1: np.ndarray, in0: np.ndarray,
             ek: EvalKey, negate: bool = False) -> np.ndarray:
    """__MuxBootstrap__ (lvl0 inputs): AND(c,in1) + ANDNY(c,in0) rotations,
    add, b += mu, extract, keyswitch — bootstrap_gpu.cu:514-588."""
    p = ek.params
    mu0, mu1 = p.lvl0.mu, p.lvl1.mu
    acc1 = blind_rotate(inc, mu1, ek, pre=(1, 1, (-mu0) % _MOD, in1))
    acc0 = blind_rotate(inc, mu1, ek, pre=(-1, 1, (-mu0) % _MOD, in0))
    acc = _u32(acc1.astype(np.int64) + acc0.astype(np.int64))
    if negate:
        acc = _u32(-acc.astype(np.int64))
        acc[p.lvl1.k, 0] = _u32(int(acc[p.lvl1.k, 0]) - mu1)
    else:
        acc[p.lvl1.k, 0] = _u32(int(acc[p.lvl1.k, 0]) + mu1)
    tlwe1 = sample_extract_index0(acc, p.lvl1)
    return key_switch(tlwe1, ek)


def mux_lvl1(inc: np.ndarray, in1: np.ndarray, in0: np.ndarray,
             ek: EvalKey, negate: bool = False) -> np.ndarray:
    """__MuxBootstrap__ (lvl1 inputs): two KS+BR, add TRLWEs, extract,
    b ± mu — bootstrap_gpu.cu:705-780."""
    p = ek.params
    mu1 = p.lvl1.mu
    t1 = key_switch(inc, ek, pre=(1, 1, (-mu1) % _MOD, in1))
    acc1 = blind_rotate(t1, mu1, ek)
    t0 = key_switch(inc, ek, pre=(-1, 1, (-mu1) % _MOD, in0))
    acc0 = blind_rotate(t0, mu1, ek)
    acc = _u32(acc1.astype(np.int64) + acc0.astype(np.int64))
    out = sample_extract_index0(acc, p.lvl1)
    d1 = p.lvl1.k * p.lvl1.n
    if negate:
        out = _u32(-out.astype(np.int64))
        out[d1] = _u32(int(out[d1]) - mu1)
    else:
        out[d1] = _u32(int(out[d1]) + mu1)
    return out


# ---------------------------------------------------------------------------
# CMUX / TRGSW user path (__CMUXNTT__, bootstrap_gpu.cu:197-285) and Refresh
# ---------------------------------------------------------------------------

def cmux(trgsw: np.ndarray, c1: np.ndarray, c0: np.ndarray,
         p: TrlweParams) -> np.ndarray:
    """res = c0 + trgsw ⊡ (c1 - c0): homomorphic select."""
    mask = U32((1 << p.Bgbit) - 1)
    half = 1 << (p.Bgbit - 1)
    off = U32((p.decomp_offset + p.decomp_roundoffset) % _MOD)
    diff = _u32(c1.astype(np.int64) - c0.astype(np.int64) + int(off))
    upd = np.zeros((p.k + 1, p.n), dtype=np.int64)
    for j in range(p.k + 1):
        for d in range(p.l):
            sh = U32(32 - (d + 1) * p.Bgbit)
            dec = ((diff[j] >> sh) & mask).astype(np.int64) - half
            row = trgsw[j * p.l + d]
            for o in range(p.k + 1):
                upd[o] += negacyclic_polymul(dec, row[o].astype(np.int64))
    return _u32(c0.astype(np.int64) + upd)


def refresh(trlwe: np.ndarray, ek: EvalKey) -> np.ndarray:
    """TRLWE noise refresh: KS(extract) → blind rotate back to TRLWE
    (__SEIandBootstrap2TRLWE__ intent, bootstrap_gpu.cu:325-364 — with the
    initial-rotation index taken from the *keyswitched* sample, i.e. without
    the reference's read-before-write quirk at bootstrap_gpu.cu:347)."""
    p = ek.params
    tlwe1 = sample_extract_index0(trlwe, p.lvl1)
    tlwe0 = key_switch(tlwe1, ek)
    return blind_rotate(tlwe0, p.lvl1.mu, ek)


def bootstrap_tlwe2trlwe(tlwe0: np.ndarray, mu: int, ek: EvalKey) -> np.ndarray:
    """GateBootstrappingTLWE2TRLWElvl01NTT (bootstrap_gpu.cu:806-815)."""
    return blind_rotate(tlwe0, mu, ek)


def sei_and_ks(trlwe: np.ndarray, ek: EvalKey) -> np.ndarray:
    """SampleExtractAndKeySwitch (keyswitch_gpu.cu:26-40)."""
    return key_switch(sample_extract_index0(trlwe, ek.params.lvl1), ek)
