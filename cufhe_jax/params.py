"""Parameter sets for TFHE gate bootstrapping.

The reference (cuFHE) takes all parameters from the TFHEpp submodule at compile
time, selected by CMake flags (USE_80BIT_SECURITY / USE_CGGI19 / USE_CONCRETE;
see /root/reference/CMakeLists.txt:8-12 and include/cufheparams.hpp). The TFHEpp
submodule is empty in the reference snapshot, so the concrete numeric values
below are reconstructed from the published TFHEpp / TFHE / CONCRETE parameter
sets. Unlike the reference, parameters here are *runtime* values (frozen
dataclasses): JAX specializes compiled programs per parameter set via jit, so
no build flags are needed.

Shape conventions (all torus values are uint32, i.e. Z_{2^32}):
  TLWE  level-L ciphertext: [k*n + 1]   (a_0..a_{kn-1}, b)
  TRLWE ciphertext:         [k+1, N]    (a polys first, b last  — matches the
                                         reference layout, cufhe_gpu.cuh:102)
  TRGSW ciphertext:         [(k+1)*l, k+1, N]
  BootstrappingKey:         [n0, (k+1)*l, k+1, N]    (bootstrap_gpu.cu:111-143)
  KeySwitchingKey:          [k1*N, t, 2^(basebit-1), k0*n0 + 1]
                                                     (keyswitch_gpu.cuh:60-75)
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LweParams:
    """TLWE (scalar LWE) parameter set — reference: TFHEpp lvl0param/lvl1param."""

    n: int                 # LWE dimension (per poly; total dim = k*n)
    k: int = 1             # number of mask polynomials / blocks
    alpha: float = 0.0     # stddev of modular-Gaussian noise (fraction of torus)
    mu: int = 1 << 29      # plaintext amplitude (1/8 of the torus)

    @property
    def dim(self) -> int:
        return self.k * self.n


@dataclasses.dataclass(frozen=True)
class TrlweParams:
    """TRLWE/TRGSW parameter set — reference: TFHEpp lvl1param."""

    nbit: int              # log2(N)
    k: int = 1
    l: int = 3             # gadget decomposition length
    Bgbit: int = 6         # gadget base bits (Bg = 2**Bgbit)
    alpha: float = 0.0
    mu: int = 1 << 29

    @property
    def n(self) -> int:
        return 1 << self.nbit

    @property
    def Bg(self) -> int:
        return 1 << self.Bgbit

    @property
    def decomp_offset(self) -> int:
        """offsetgen() — gatebootstrapping_gpu.cuh:18-27."""
        off = 0
        for i in range(1, self.l + 1):
            off += (self.Bg // 2) * (1 << (32 - i * self.Bgbit))
        return off & 0xFFFFFFFF

    @property
    def decomp_roundoffset(self) -> int:
        """roundoffset — gatebootstrapping_gpu.cuh:64-66."""
        return 1 << (32 - self.l * self.Bgbit - 1)

    def as_lwe(self) -> LweParams:
        """The LWE view of extracted samples (dimension k*N)."""
        return LweParams(n=self.n, k=self.k, alpha=self.alpha, mu=self.mu)


@dataclasses.dataclass(frozen=True)
class KeySwitchParams:
    """Identity key switch — reference: TFHEpp lvl10param (keyswitch_gpu.cuh)."""

    t: int = 8             # number of decomposition digits
    basebit: int = 2       # digit width in bits

    @property
    def numbase(self) -> int:
        return 1 << (self.basebit - 1)

    @property
    def decomp_offset(self) -> int:
        """iksoffsetgen() — keyswitch_gpu.cuh:13-23."""
        off = 0
        for i in range(1, self.t + 1):
            off += ((1 << self.basebit) // 2) * (1 << (32 - i * self.basebit))
        return off & 0xFFFFFFFF

    @property
    def roundoffset(self) -> int:
        """keyswitch_gpu.cuh:34-37."""
        if self.basebit * self.t < 32:
            return 1 << (32 - (1 + self.basebit * self.t))
        return 0


@dataclasses.dataclass(frozen=True)
class GateParams:
    """Full gate-bootstrapping parameter bundle.

    Mirrors the reference's ⟨lvl01param, lvl1param::mu, lvl10param⟩ template
    instantiations (bootstrap_gpu.cu:849,866): `lvl0` is the small LWE level,
    `lvl1` the TRLWE level, `ks` the lvl1→lvl0 key switch.
    """

    name: str
    lvl0: LweParams
    lvl1: TrlweParams
    ks: KeySwitchParams

    @property
    def n0(self) -> int:
        return self.lvl0.dim

    @property
    def N(self) -> int:
        return self.lvl1.n


# ---------------------------------------------------------------------------
# Presets. Noise parameters follow the published TFHEpp / TFHE-lib / CONCRETE
# sets; the reference selects among these with CMake flags (CMakeLists.txt:8-12).
# ---------------------------------------------------------------------------

#: TFHEpp 128-bit default (cuFHE's default build).
TFHEPP_128 = GateParams(
    name="tfhepp_128bit",
    lvl0=LweParams(n=636, k=1, alpha=0.0000925119974676756, mu=1 << 29),
    lvl1=TrlweParams(nbit=10, k=1, l=3, Bgbit=6,
                     alpha=0.0000000342338787018369, mu=1 << 29),
    ks=KeySwitchParams(t=8, basebit=2),
)

#: Fast variant of the 128-bit set: same LWE dimensions and noise rates
#: (identical security), but gadget decomposition l=2 / Bg=256 instead of
#: l=3 / Bg=64 — 33% less external-product work per bootstrap. The cost is
#: a larger correctness-noise budget: phase noise std rises from ~2^25.2 to
#: ~2^25.6 on the 2^32 torus (decision margin mu/2 = 2^28), putting the
#: per-gate failure rate near the original TFHE-lib's ~2^-25 instead of
#: TFHEpp's more conservative default. Measured 0 errors across all test
#: batches; choose per deployment.
TFHEPP_128_BG8 = GateParams(
    name="tfhepp_128bit_bg8",
    lvl0=LweParams(n=636, k=1, alpha=0.0000925119974676756, mu=1 << 29),
    lvl1=TrlweParams(nbit=10, k=1, l=2, Bgbit=8,
                     alpha=0.0000000342338787018369, mu=1 << 29),
    ks=KeySwitchParams(t=8, basebit=2),
)

#: USE_80BIT_SECURITY — original CGGI16 80-bit set.
TFHEPP_80 = GateParams(
    name="tfhepp_80bit",
    lvl0=LweParams(n=500, k=1, alpha=2.44e-5, mu=1 << 29),
    lvl1=TrlweParams(nbit=10, k=1, l=2, Bgbit=10, alpha=3.73e-9, mu=1 << 29),
    ks=KeySwitchParams(t=8, basebit=2),
)

#: USE_CGGI19 — CGGI19 128-bit set.
CGGI19 = GateParams(
    name="cggi19",
    lvl0=LweParams(n=630, k=1, alpha=3.0517578125e-05, mu=1 << 29),
    lvl1=TrlweParams(nbit=10, k=1, l=3, Bgbit=7, alpha=2.9802322387695312e-08,
                     mu=1 << 29),
    ks=KeySwitchParams(t=8, basebit=2),
)

#: USE_CONCRETE — CONCRETE boolean default (k=2, N=512; bootstrap_gpu.cu:543).
CONCRETE = GateParams(
    name="concrete",
    lvl0=LweParams(n=586, k=1, alpha=9.25119974676756e-05, mu=1 << 29),
    lvl1=TrlweParams(nbit=9, k=2, l=2, Bgbit=8, alpha=2.9802322387695312e-08,
                     mu=1 << 29),
    ks=KeySwitchParams(t=5, basebit=2),
)

#: N=2048-class set for radix-4 (msg_bits=2) encrypted integers — the
#: documented unblock for the theta=1 mod-switch noise floor that caps
#: radix-4 at N=1024 (BENCHMARKS.md r4). Beyond the reference's parameter
#: menu (its one N=2048 struct, cuFHElvl2param at cufheparams.hpp:5-20, is
#: u64-torus and unused by any code path); this stays on the u32 torus the
#: whole stack is built on. Error budget at msg_bits=2 (delta/2 = 2^27):
#:   mod-switch (theta=1, nbit=11, n0=1024): std ~2^23.7  (was 2^25.7)
#:   blind rotation (l=3, Bg=512, alpha1=2^-31):   ~2^22
#:   keyswitch (t=8/b=2, alpha0=2^-17):            ~2^22
#:   => next-add input sigma ~2^24.2 -> ~6.8-sigma digit margin (vs the
#:      ~4-sigma hard floor measured for radix-4 at the 128-bit set).
#: Measured (benchmarks/integers.py --params radix4_2048 --msg-bits 2
#: --bits 32; bit-exact arithmetic, so device-independent): digit noise
#: std 2^21.83, next-add margin 8.87 sigma, 0 digit/word errors — the
#: budget above was conservative (red-gate floor 8.0 in
#: benchmarks/noise.py INT_MARGIN_FLOORS).
#: Security: LWE n=1024/alpha 2^-17 and RLWE N=2048/alpha 2^-31 both sit
#: well above the 128-bit line (lattice-estimator-style extrapolation from
#: the published 636/2^-13.4 and 1024/2^-24.8 points).
#: Cost model (why this is noise-viable but not expected to be a throughput
#: win): rotations/bit halve (radix-4), but each rotation's dense
#: negacyclic product costs ~(2048/1024)^2 = 4x x (n0 1024/636) ~ 1.6x, in
#: exchange for halving depth (latency) of digit-serial circuits. Not
#: measured on the GPU.
RADIX4_2048 = GateParams(
    name="radix4_2048",
    lvl0=LweParams(n=1024, k=1, alpha=2.0 ** -17, mu=1 << 29),
    lvl1=TrlweParams(nbit=11, k=1, l=3, Bgbit=9, alpha=2.0 ** -31,
                     mu=1 << 29),
    ks=KeySwitchParams(t=8, basebit=2),
)

#: Tiny insecure parameters for fast exact unit tests (alpha = 0 everywhere so
#: the whole pipeline is deterministic; decomposition/modswitch rounding is the
#: only "noise").
TINY = GateParams(
    name="tiny-insecure-test",
    lvl0=LweParams(n=16, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=6, k=1, l=2, Bgbit=6, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: "Quiet" tiny set for the radix-4 (msg_bits=2) integer layer, whose
#: delta/2 = 2^26 LUT margins sit far below the gate margins. All three
#: deterministic (alpha=0) error terms are pushed out of range: N=512
#: (theta=1 mod-switch rounding ~2^23 vs TINY's ~2^25.7 — the dominant
#: radix-4 blocker, BENCHMARKS.md r4), l=3/Bg=2^8 (decomposition rounding
#: ~2^7), and a t=7/basebit=3 keyswitch (KS rounding ~2^10 vs ~2^23).
#: Mirrors the production finding that radix-4 needs an N=2048-class set,
#: not merely a quieter gadget.
TINY_Q = GateParams(
    name="tiny-quiet-ks-insecure-test",
    lvl0=LweParams(n=16, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=9, k=1, l=3, Bgbit=8, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=7, basebit=3),
)

#: Tiny-but-N=128 insecure set (the smallest N of the production shape
#: class); the bit-exactness tests of the resolved path run on it.
TINY_N128 = GateParams(
    name="tiny-n128-insecure-test",
    lvl0=LweParams(n=8, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=7, k=1, l=2, Bgbit=6, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: Tiny with k=2 to exercise the CONCRETE-style multi-block path.
TINY_K2 = GateParams(
    name="tiny-k2-insecure-test",
    lvl0=LweParams(n=12, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=5, k=2, l=2, Bgbit=6, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: Tiny k=2 with N=128: the CONCRETE-style multi-block shape.
TINY_K2_N128 = GateParams(
    name="tiny-k2-n128-insecure-test",
    lvl0=LweParams(n=8, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=7, k=2, l=2, Bgbit=8, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: Tiny Bg=1024 set exercising the digit-limb split (the 80-bit set's
#: gadget shape).
TINY_BG10 = GateParams(
    name="tiny-bg10-insecure-test",
    lvl0=LweParams(n=8, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=7, k=1, l=2, Bgbit=10, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: Tiny N=512 / Bgbit=6 set: a mid-size ring with the 128-bit gadget.
TINY_N512 = GateParams(
    name="tiny-n512-insecure-test",
    lvl0=LweParams(n=8, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=9, k=1, l=2, Bgbit=6, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

#: Tiny N=512 / Bg=1024 set: the digit-limb split (nd=2 sub-digits of
#: dbits=6) at a mid-size ring.
TINY_BG10_N512 = GateParams(
    name="tiny-bg10-n512-insecure-test",
    lvl0=LweParams(n=8, k=1, alpha=0.0, mu=1 << 29),
    lvl1=TrlweParams(nbit=9, k=1, l=2, Bgbit=10, alpha=0.0, mu=1 << 29),
    ks=KeySwitchParams(t=4, basebit=2),
)

PRESETS = {p.name: p for p in (TFHEPP_128, TFHEPP_128_BG8, TFHEPP_80, CGGI19,
                               CONCRETE, RADIX4_2048, TINY, TINY_Q,
                               TINY_N128, TINY_K2,
                               TINY_K2_N128, TINY_BG10, TINY_N512,
                               TINY_BG10_N512)}
DEFAULT = TFHEPP_128
