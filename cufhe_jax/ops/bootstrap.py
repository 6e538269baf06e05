"""Gate bootstrapping programs: blind rotation, gates, Mux, CMUX, Refresh.

Each reference fused CUDA kernel (__HomGate__ and friends, bootstrap_gpu.cu)
becomes a single jitted XLA program over a ciphertext *batch*: the
one-block-per-gate + streams model maps to the leading batch axis, and the
inherently sequential n0-step accumulator loop is a lax.fori_loop
(SURVEY.md §7 design stance).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..params import GateParams
from .keys import DeviceKeys
from .keyswitch import key_switch
from .poly import (batched_test_vector, decompose, decompose_rotate_sub,
                   negacyclic_conv_i8, negacyclic_conv_toeplitz,
                   rotate_by_xai, sample_extract_for_ks,
                   sample_extract_index0, split_decomp_digits)

U32 = jnp.uint32


def _mod_switch(phase: jnp.ndarray, nbit: int) -> jnp.ndarray:
    """modSwitchFromTorus (gatebootstrapping_gpu.cuh:10-16)."""
    return phase >> U32(32 - 1 - nbit)


def _mod_switch_round(phase: jnp.ndarray, nbit: int,
                      theta: int) -> jnp.ndarray:
    """Mod switch rounded to a multiple of 2^theta windows (PBSmanyLUT;
    golden.mod_switch_round). theta=0 equals the reference's rounded
    a-coefficient switch (_mod_switch(x + roundoffset))."""
    sh = 32 - 1 - nbit + theta
    return ((phase + U32(1 << (sh - 1))) >> U32(sh)) << U32(theta)


#: Blind-rotation backends, all plain XLA. "conv" and "toeplitz" are exact
#: int8 limb products; "ntt" adds mod-p discretization noise, so it is never
#: chosen by "auto" (it is not bit-identical to the golden model).
BACKENDS = ("conv", "toeplitz", "ntt")


def resolve_backend(backend: str, params: GateParams) -> str:
    """'auto' -> the backend measured fastest among the bit-exact ones.

    "toeplitz" at every shape: on the H100 it is the only exact backend XLA
    compiles (the GPU compiler refuses "conv"'s int8 -> int32 convolution),
    and it beat "ntt" there as well (PERF.md). The rule reads no platform,
    so the CPU tests exercise the very path the GPU runs."""
    if backend == "auto":
        return "toeplitz"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose 'auto' or "
                         f"one of {BACKENDS}")
    return backend


def _conv_update(dec: jnp.ndarray, bk_i, params: GateParams,
                 backend: str) -> jnp.ndarray:
    """One external product: decomposed digits x one TRGSW -> [B,k+1,N] u32."""
    backend = resolve_backend(backend, params)
    if backend == "ntt":   # single products stay on an exact limb path
        backend = resolve_backend("auto", params)
    lp = params.lvl1
    out = None
    dec_limbs, bits = split_decomp_digits(dec, lp.Bgbit)
    for dl, d8 in enumerate(dec_limbs):
        if backend == "conv":
            upd = negacyclic_conv_i8(d8, bk_i["filters"], lp.k)
        else:
            upd = negacyclic_conv_toeplitz(d8, bk_i["limbs"], lp.k)
        if dl:
            upd = upd << U32(bits * dl)
        out = upd if out is None else out + upd
    return out


def blind_rotate(a: jnp.ndarray, b: jnp.ndarray, mu: int, keys: DeviceKeys,
                 params: GateParams, backend: str = "auto") -> jnp.ndarray:
    """__BlindRotate__ (gatebootstrapping_gpu.cuh:287-314), batched.

    a: [B, n0] uint32 mask, b: [B] uint32 body (gate pre-add already fused by
    the caller). Returns the TRLWE accumulator [B, k+1, N] uint32.
    """
    lp = params.lvl1
    bar = U32(2 * lp.n) - _mod_switch(b, lp.nbit)
    acc = batched_test_vector(bar, mu, lp)
    return blind_rotate_acc(acc, a, keys, params, backend)


def blind_rotate_tv(a: jnp.ndarray, b: jnp.ndarray, tv: jnp.ndarray,
                    keys: DeviceKeys, params: GateParams,
                    backend: str = "auto",
                    theta: Optional[int] = None) -> jnp.ndarray:
    """Blind rotation with a CUSTOM test polynomial — the core of
    programmable (functional) bootstrapping. `tv` is [N] or [B, N] uint32:
    the returned TRLWE's constant slot carries tv evaluated at the
    modswitched input phase (negacyclic: windows N..2N-1 see -tv). The
    constant-mu gate test vector (batched_test_vector) is the special case
    tv = mu * (1, 1, ..., 1).

    theta (None = legacy truncating switch for b) selects the PBSmanyLUT
    rounded mod switch: every switched window — b's included — is rounded
    to a multiple of 2^theta windows (golden.blind_rotate_tv_many)."""
    lp = params.lvl1
    B = a.shape[0]
    if theta is None:
        bar = U32(2 * lp.n) - _mod_switch(b, lp.nbit)
    else:
        bar = U32(2 * lp.n) - _mod_switch_round(b, lp.nbit, theta)
    acc0 = jnp.zeros((B, lp.k + 1, lp.n), U32).at[:, lp.k, :].set(
        jnp.broadcast_to(jnp.asarray(tv, U32), (B, lp.n)))
    # bar == 2N (b = 0) wraps to rotation 0 — the reference's special case
    # (gatebootstrapping_gpu.cuh:33-37) falls out of the masked form
    acc = rotate_by_xai(acc0, bar & U32(2 * lp.n - 1), lp)
    return blind_rotate_acc(acc, a, keys, params, backend, theta=theta)


def blind_rotate_acc(acc: jnp.ndarray, a: jnp.ndarray, keys: DeviceKeys,
                     params: GateParams, backend: str = "auto",
                     theta: Optional[int] = None) -> jnp.ndarray:
    """The n0-iteration CMUX accumulator loop from an explicit initial
    accumulator [B, k+1, N] (the rotated test vector).

    theta > 0 rounds each a-coefficient's switched window to a multiple of
    2^theta windows (PBSmanyLUT); theta in (None, 0) is the reference's
    rounded switch (identical results — the roundoffset IS the theta=0
    rounding)."""
    backend = resolve_backend(backend, params)
    lp = params.lvl1
    n0 = params.lvl0.dim
    roundoffset = U32(1 << (32 - 2 - lp.nbit))
    if theta:
        _msw = lambda x: _mod_switch_round(x, lp.nbit, theta)  # noqa: E731
    else:
        _msw = lambda x: _mod_switch(x + roundoffset, lp.nbit)  # noqa: E731

    if backend == "ntt":
        # USE_SMALL_NTT_MODULUS gate mode (ntt_small_modulus.cuh; facade
        # ntt.cuh:49-178): digits and BK lifted to the RAINTT prime, the
        # external product as fwd-NTT -> pointwise Shoup MAC -> inv-NTT,
        # the accumulator round-tripped through the torus<->mod-p
        # discretization each iteration exactly as the reference's
        # NTTInv(Add)WithModSwitch does. The discretization adds ~2^12-scale
        # phase noise (negligible vs the ~2^25 blind-rotation noise), so
        # the output is not bit-identical to the golden model.
        from .ntt import (P, addmod, make_tables, mod_to_torus_jax,
                          mulmod_shoup, ntt_forward, ntt_inverse)
        tabs = {k: jnp.asarray(v) for k, v in make_tables(lp.nbit).items()}
        I = (lp.k + 1) * lp.l

        def ntt_body(i, acc):
            a_i = lax.dynamic_index_in_dim(a, i, axis=1, keepdims=False)
            a_bar = _msw(a_i)
            dec = decompose_rotate_sub(acc, a_bar, lp)   # [B, I, N] int32
            dmod = jnp.where(dec < 0, dec + jnp.int32(P), dec).astype(U32)
            dntt = ntt_forward(dmod, tabs)
            bk_i = lax.dynamic_index_in_dim(keys.bk_ntt, i, 0, False)
            sh_i = lax.dynamic_index_in_dim(keys.bk_ntt_shoup, i, 0, False)
            outs = []
            for o in range(lp.k + 1):
                s = None
                for r in range(I):
                    t = mulmod_shoup(dntt[:, r], bk_i[None, r, o],
                                     sh_i[None, r, o])
                    s = t if s is None else addmod(s, t)
                outs.append(s)
            upd = ntt_inverse(jnp.stack(outs, axis=1), tabs)
            return acc + mod_to_torus_jax(upd)

        return lax.fori_loop(0, n0, ntt_body, acc)

    def body(i, acc):
        a_i = lax.dynamic_index_in_dim(a, i, axis=1, keepdims=False)
        a_bar = _msw(a_i)
        dec = decompose_rotate_sub(acc, a_bar, lp)
        src = keys.bk_limbs if backend == "toeplitz" else keys.bk_filters
        key = "limbs" if backend == "toeplitz" else "filters"
        bk_i = {key: lax.dynamic_index_in_dim(src, i, 0, False)}
        return acc + _conv_update(dec, bk_i, params, backend)

    return lax.fori_loop(0, n0, body, acc)


def _u(x) -> jnp.ndarray:
    return U32(x % (1 << 32))


def _gate_coeffs(gate_consts, mu: int):
    """Gate linear-combination constants as u32 operands.

    Accepts either the (ca, cb, om) int tuple from golden.GATE_CONSTANTS
    (compile-time specialization, one program per gate — the reference's
    template-instantiation model, bootstrap_gpu.cu:424-512) or a traced
    uint32[3] array (ca, cb, om*mu pre-encoded) so ONE compiled program
    serves all ten two-input gates.
    """
    if isinstance(gate_consts, (tuple, list)):
        ca, cb, om = gate_consts
        return _u(ca), _u(cb), _u(om * mu)
    if gate_consts.ndim == 2:
        # per-row constants [B, 3]: one compiled program evaluates a MIX of
        # two-input gates in a single batch (executor level fusion) —
        # shapes broadcast against [B, dim+1] ciphertexts
        return (gate_consts[:, 0:1], gate_consts[:, 1:2], gate_consts[:, 2])
    return gate_consts[0], gate_consts[1], gate_consts[2]


def encode_gate_consts(gate_consts, mu: int):
    """Host-side encoding of (ca, cb, om) -> uint32[3] (ca, cb, om*mu)."""
    import numpy as np
    ca, cb, om = gate_consts
    return jnp.asarray(np.array([ca % (1 << 32), cb % (1 << 32),
                                 (om * mu) % (1 << 32)], dtype=np.uint32))


def encode_gate_consts_rows(names, mu: int):
    """[len(names), 3] uint32 per-row constants: row i encodes gate
    names[i]. Feeding this as `gate_consts` evaluates a heterogeneous mix
    of two-input gates in one compiled program (executor level fusion)."""
    import numpy as np
    from ..golden import GATE_CONSTANTS
    rows = np.empty((len(names), 3), dtype=np.uint32)
    for i, nm in enumerate(names):
        ca, cb, om = GATE_CONSTANTS[nm]
        rows[i] = (ca % (1 << 32), cb % (1 << 32), (om * mu) % (1 << 32))
    return rows


def _pre_add(in0, in1, ca_u, cb_u, off_u, dim):
    comb = ca_u * in0 + cb_u * in1
    return comb[:, :dim], comb[:, dim] + off_u


def gate_lvl0(gate_consts, in0: jnp.ndarray, in1: jnp.ndarray,
              keys: DeviceKeys, params: GateParams,
              backend: str = "auto") -> jnp.ndarray:
    """__HomGate__ br->iks order (bootstrap_gpu.cu:402-421): lvl0 inputs,
    fused pre-add into the mod switch, BR, extract, KS back to lvl0."""
    ca, cb, off = _gate_coeffs(gate_consts, params.lvl0.mu)
    n0 = params.lvl0.dim
    a, b = _pre_add(in0, in1, ca, cb, off, n0)
    acc = blind_rotate(a, b, params.lvl1.mu, keys, params, backend)
    # extraction folded into the KSK row permutation (sample_extract_for_ks)
    tlwe1 = sample_extract_for_ks(acc, params.lvl1)
    return key_switch(tlwe1, keys.ksk_limbs_sei, params)


def gate_lvl1(gate_consts, in0: jnp.ndarray, in1: jnp.ndarray,
              keys: DeviceKeys, params: GateParams,
              backend: str = "auto") -> jnp.ndarray:
    """__HomGate__ iks->br order (bootstrap_gpu.cu:383-400): lvl1 inputs,
    pre-add fused into the key switch, BR, extract to lvl1."""
    ca, cb, off = _gate_coeffs(gate_consts, params.lvl1.mu)
    tlwe0 = key_switch(in0, keys.ksk_limbs, params, pre=(ca, cb, off, in1))
    acc = blind_rotate(tlwe0[:, :params.lvl0.dim], tlwe0[:, params.lvl0.dim],
                       params.lvl1.mu, keys, params, backend)
    return sample_extract_index0(acc, params.lvl1)


def mux_lvl0(inc, in1, in0, keys: DeviceKeys, params: GateParams,
             negate: bool = False, backend: str = "auto") -> jnp.ndarray:
    """__MuxBootstrap__/__NMuxBootstrap__ lvl0 (bootstrap_gpu.cu:514-588)."""
    n0 = params.lvl0.dim
    mu0, mu1 = params.lvl0.mu, params.lvl1.mu
    a1, b1 = _pre_add(inc, in1, _u(1), _u(1), _u(-mu0), n0)
    acc1 = blind_rotate(a1, b1, mu1, keys, params, backend)
    a0, b0 = _pre_add(inc, in0, _u(-1), _u(1), _u(-mu0), n0)
    acc0 = blind_rotate(a0, b0, mu1, keys, params, backend)
    acc = acc1 + acc0
    if negate:
        acc = jnp.negative(acc)
        acc = acc.at[:, params.lvl1.k, 0].add(U32((-mu1) % (1 << 32)))
    else:
        acc = acc.at[:, params.lvl1.k, 0].add(U32(mu1))
    tlwe1 = sample_extract_for_ks(acc, params.lvl1)
    return key_switch(tlwe1, keys.ksk_limbs_sei, params)


def mux_lvl1(inc, in1, in0, keys: DeviceKeys, params: GateParams,
             negate: bool = False, backend: str = "auto") -> jnp.ndarray:
    """__MuxBootstrap__/__NMuxBootstrap__ lvl1 (bootstrap_gpu.cu:705-780)."""
    n0 = params.lvl0.dim
    d1 = params.lvl1.k * params.lvl1.n
    mu1 = params.lvl1.mu
    t1 = key_switch(inc, keys.ksk_limbs, params,
                    pre=(_u(1), _u(1), _u(-mu1), in1))
    acc1 = blind_rotate(t1[:, :n0], t1[:, n0], mu1, keys, params, backend)
    t0 = key_switch(inc, keys.ksk_limbs, params,
                    pre=(_u(-1), _u(1), _u(-mu1), in0))
    acc0 = blind_rotate(t0[:, :n0], t0[:, n0], mu1, keys, params, backend)
    out = sample_extract_index0(acc1 + acc0, params.lvl1)
    if negate:
        out = jnp.negative(out)
        out = out.at[:, d1].add(U32((-mu1) % (1 << 32)))
    else:
        out = out.at[:, d1].add(U32(mu1))
    return out


def not_gate(ct: jnp.ndarray) -> jnp.ndarray:
    """__NotBootstrap__ — pure negation (bootstrap_gpu.cu:692-703)."""
    return jnp.negative(ct)


def copy_gate(ct: jnp.ndarray) -> jnp.ndarray:
    return ct


def cmux(trgsw_dev: dict, c1: jnp.ndarray, c0: jnp.ndarray,
         params: GateParams, backend: str = "auto") -> jnp.ndarray:
    """__CMUXNTT__ (bootstrap_gpu.cu:197-285): c0 + trgsw ⊡ (c1-c0), batched.
    trgsw_dev comes from keys.prepare_trgsw (the TRGSW2NTT analogue)."""
    lp = params.lvl1
    off = U32((lp.decomp_offset + lp.decomp_roundoffset) % (1 << 32))
    dec = decompose(c1 - c0 + off, lp)
    return c0 + _conv_update(dec, trgsw_dev, params, backend)


def refresh(trlwe: jnp.ndarray, keys: DeviceKeys, params: GateParams,
            backend: str = "auto") -> jnp.ndarray:
    """TRLWE -> TRLWE noise refresh (__SEIandBootstrap2TRLWE__ intent,
    bootstrap_gpu.cu:325-364; see golden.refresh re the reference quirk)."""
    tlwe1 = sample_extract_for_ks(trlwe, params.lvl1)
    tlwe0 = key_switch(tlwe1, keys.ksk_limbs_sei, params)
    n0 = params.lvl0.dim
    return blind_rotate(tlwe0[:, :n0], tlwe0[:, n0], params.lvl1.mu, keys,
                        params, backend)


def bootstrap_tlwe2trlwe(tlwe0: jnp.ndarray, mu: int, keys: DeviceKeys,
                         params: GateParams,
                         backend: str = "auto") -> jnp.ndarray:
    """GateBootstrappingTLWE2TRLWElvl01NTT (bootstrap_gpu.cu:806-815)."""
    n0 = params.lvl0.dim
    return blind_rotate(tlwe0[:, :n0], tlwe0[:, n0], mu, keys, params,
                        backend)


def sei_and_ks(trlwe: jnp.ndarray, keys: DeviceKeys,
               params: GateParams) -> jnp.ndarray:
    """SampleExtractAndKeySwitch (keyswitch_gpu.cu:26-40)."""
    return key_switch(sample_extract_for_ks(trlwe, params.lvl1),
                      keys.ksk_limbs_sei, params)


def pbs_tlwe2trlwe(tlwe0: jnp.ndarray, tv: jnp.ndarray, keys: DeviceKeys,
                   params: GateParams, backend: str = "auto") -> jnp.ndarray:
    """Programmable bootstrap, TLWE -> TRLWE: blind-rotate a custom test
    polynomial by the input phase. Beyond the reference's capability set
    (its test vector is pinned to the constant mu); same kernels."""
    n0 = params.lvl0.dim
    return blind_rotate_tv(tlwe0[:, :n0], tlwe0[:, n0], tv, keys, params,
                           backend)


def programmable_bootstrap(tlwe0: jnp.ndarray, tv: jnp.ndarray,
                           keys: DeviceKeys, params: GateParams,
                           backend: str = "auto") -> jnp.ndarray:
    """Full programmable bootstrap: custom-test-vector blind rotation,
    sample extract, keyswitch back to lvl0. Output encrypts tv[w] (or
    -tv[w - N]) where w is the modswitched input phase window."""
    acc = pbs_tlwe2trlwe(tlwe0, tv, keys, params, backend)
    return sei_and_ks(acc, keys, params)


def pbs_many(tlwe0: jnp.ndarray, tv: jnp.ndarray, J: int, keys: DeviceKeys,
             params: GateParams, backend: str = "auto",
             theta: Optional[int] = None) -> jnp.ndarray:
    """Multi-output programmable bootstrap (PBSmanyLUT): ONE blind
    rotation evaluates J interleaved LUTs per ciphertext.

    The mod switch is rounded to multiples of 2^theta windows
    (_mod_switch_round), so accumulator coefficient j is exactly tv[w+j]
    for the 2^theta-aligned window w: J negacyclic rotations (X^{-j} is a
    compile-time barrel shift) share ONE batched extract+keyswitch. The
    reference has no PBS at all (its test vector is pinned,
    gatebootstrapping_gpu.cuh:29-52); this rides the same kernels and is
    the workhorse of the encrypted-integer layer (models/integers.py:
    full adder = one rotation). Bit-exact vs golden.pbs_many.

    tlwe0: [B, n0+1]; tv: [N] or [B, N]. Returns [J, B, n0+1] lvl0
    ciphertexts — output j encrypts LUT_j of the input."""
    if theta is None:
        theta = (J - 1).bit_length()
    assert J <= 1 << theta, (J, theta)
    n0 = params.lvl0.dim
    lp = params.lvl1
    acc = blind_rotate_tv(tlwe0[:, :n0], tlwe0[:, n0], tv, keys, params,
                          backend, theta=theta)
    B = acc.shape[0]
    rots = [acc] + [rotate_by_xai(acc, jnp.full((B,), U32(2 * lp.n - j)),
                                  lp)
                    for j in range(1, J)]
    stacked = jnp.concatenate(rots, axis=0)          # [J*B, k+1, N]
    out = key_switch(sample_extract_for_ks(stacked, lp),
                     keys.ksk_limbs_sei, params)
    return out.reshape(J, B, n0 + 1)
