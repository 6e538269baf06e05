"""Device key preparation — the analogue of BootstrappingKeyToNTT +
KeySwitchingKeyToDevice (bootstrap_gpu.cu:111-143, keyswitch_gpu.cu:6-16).

Where the reference converts the BK to NTT form once at Initialize(), we
convert it once to *signed-byte limb* form: the representation the exact
int8 products consume directly. Keys are read-only and replicated across the device mesh
(the multi-GPU replication strategy, cufhe_gpu.cuh:76-95, made explicit).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..golden import EvalKey
from ..params import GateParams
from .limbs import NLIMBS, u32_to_signed_limbs


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceKeys:
    """Limb-encoded evaluation keys living on device (pytree).

    bk_filters: [n0, (k+1)*NLIMBS, (k+1)*l, N] int8 — reversed filters for
        the conv backend; output channel o*NLIMBS + limb.
    bk_limbs:   [n0, NLIMBS, (k+1)*l, k+1, N] int8 — natural order, for the
        Toeplitz backend.
    ksk_limbs:  [NLIMBS, t*numbase*k1*N, k0*n0+1] bfloat16 — flattened KSK
        with contraction index (dig*numbase + m)*k1*N + j — (dig, m, j)
        block-major, matching ks_decompose_coeffs's lane-concatenated
        selection layout (the reference's gather layout,
        keyswitch_gpu.cuh:68-71, transposed for a matrix product). Stored
        as bf16 so the keyswitch dots need no per-call cast; the int8 limb
        values are exactly representable.
    ksk_limbs_sei: same, with each per-component row block permuted by the
        negacyclic index reversal j -> (N - j) mod N, so a key switch fed
        the elementwise KS-input extraction (poly.sample_extract_for_ks)
        equals KS(SampleExtractIndex0(acc)) without the device-side lane
        reverse.
    bk_ntt / bk_ntt_shoup: [n0, (k+1)*l, k+1, N] uint32 — BK discretized to
        the RAINTT modulus and forward-transformed, with Shoup companions
        (the USE_SMALL_NTT_MODULUS key form, ntt_small_modulus.cuh;
        'ntt' backend only).

    Only the formats for the requested backends are materialized; absent
    ones hold a zero-size placeholder so the pytree structure stays static.
    """
    bk_filters: jnp.ndarray
    bk_limbs: jnp.ndarray
    ksk_limbs: jnp.ndarray
    ksk_limbs_sei: jnp.ndarray
    bk_ntt: jnp.ndarray
    bk_ntt_shoup: jnp.ndarray


def prepare_trgsw(trgsw: np.ndarray, params: GateParams) -> dict:
    """Limb-encode one user TRGSW (the TRGSW2NTT analogue,
    bootstrap_gpu.cu:75-94) for CMUX. trgsw: [(k+1)l, k+1, N] uint32."""
    limbs = u32_to_signed_limbs(trgsw)              # [(k+1)l, k+1, N, L]
    nat = np.moveaxis(limbs, 3, 0)                  # [L, (k+1)l, k+1, N]
    filt = np.moveaxis(limbs, 3, 2)                 # [(k+1)l, k+1, L, N]
    kp1 = trgsw.shape[1]
    filt = filt.reshape(trgsw.shape[0], kp1 * NLIMBS, trgsw.shape[2])
    filt = np.moveaxis(filt, 0, 1)[..., ::-1]       # [O, I, N] reversed
    return {"filters": jnp.asarray(np.ascontiguousarray(filt)),
            "limbs": jnp.asarray(nat)}


def prepare_keys(ek: EvalKey, device=None,
                 backends: Optional[tuple] = None,
                 host: bool = False) -> DeviceKeys:
    """One-time host-side key conversion + upload (Initialize(ek) analogue,
    cufhe_gates_gpu.cu:42-47).

    backends: which compute-backend key formats to materialize, e.g.
    ("toeplitz",) or ("conv", "toeplitz"). None = both exact formats.

    host=True keeps the converted keys as NumPy arrays (no device
    placement) — useful for compile-only checks, which need only shapes.
    """
    p = ek.params
    n0 = p.lvl0.dim
    lp = p.lvl1
    kp1 = lp.k + 1
    rows = kp1 * lp.l
    want = set(backends) if backends is not None else \
        {"conv", "toeplitz"}

    # BK: [n0, rows, k+1, N] u32 -> limbs [n0, rows, k+1, N, L]
    bl = u32_to_signed_limbs(ek.bk)
    if "toeplitz" in want:
        bk_limbs = np.moveaxis(bl, 4, 1)            # [n0, L, rows, k+1, N]
    else:
        bk_limbs = np.zeros((0,), dtype=np.int8)
    if "conv" in want:
        # conv filters: [n0, O=(k+1)*L, I=rows, N], reversed along N
        filt = np.moveaxis(bl, 4, 3)                # [n0, rows, k+1, L, N]
        filt = filt.reshape(n0, rows, kp1 * NLIMBS, lp.n)
        filt = np.moveaxis(filt, 1, 2)[..., ::-1]   # [n0, O, I, N]
    else:
        filt = np.zeros((0,), dtype=np.int8)

    # KSK: [d1, t, numbase, n0+1] u32 -> [L, d1*t*numbase, n0+1] bf16
    kl = u32_to_signed_limbs(ek.ksk)                # [d1, t, nb, n0+1, L]
    d1 = ek.ksk.shape[0]
    K = d1 * p.ks.t * p.ks.numbase
    import ml_dtypes

    def _flat_ksk(limbs):
        # row order (dig, m, j)-major, matching ks_decompose_coeffs's
        # block-concatenated coefficient layout
        return np.transpose(limbs, (4, 1, 2, 0, 3)).reshape(
            NLIMBS, K, n0 + 1).astype(ml_dtypes.bfloat16)

    ksk_limbs = _flat_ksk(kl)
    # Negacyclic-reversal row permutation per lvl1 component block: lets
    # sample extraction stay elementwise on device (sample_extract_for_ks).
    perm = np.arange(d1).reshape(lp.k, lp.n)
    perm = np.concatenate([perm[:, :1], perm[:, :0:-1]], axis=1).reshape(-1)
    ksk_limbs_sei = _flat_ksk(kl[perm])

    if "ntt" in want:
        from .ntt import (make_tables, ntt_forward_host, shoup_precompute,
                          torus_to_mod_host)
        tabs = make_tables(lp.nbit)
        bk_ntt = ntt_forward_host(torus_to_mod_host(ek.bk), tabs)
        bk_ntt_shoup = shoup_precompute(bk_ntt)
    else:
        bk_ntt = np.zeros((0,), dtype=np.uint32)
        bk_ntt_shoup = np.zeros((0,), dtype=np.uint32)

    if host:
        put = np.ascontiguousarray
    elif device is not None:
        put = lambda x: jax.device_put(
            jnp.asarray(np.ascontiguousarray(x)), device)
    else:
        put = lambda x: jnp.asarray(np.ascontiguousarray(x))

    return DeviceKeys(bk_filters=put(filt), bk_limbs=put(bk_limbs),
                      ksk_limbs=put(ksk_limbs),
                      ksk_limbs_sei=put(ksk_limbs_sei),
                      bk_ntt=put(bk_ntt), bk_ntt_shoup=put(bk_ntt_shoup))
