"""Public host API: Context + typed ciphertext batches.

This is the analogue of the reference's L4 layer (include/cufhe_gpu.cuh +
src/cufhe_gates_gpu.cu): Initialize(ek) → Context(ek); Ctxt<P> → Ctxt (a
batched, level-typed array); the 14 gate wrappers → jitted batched methods;
Streams/multi-GPU → an optional mesh that shards the batch axis.

Ciphertexts live on device between gates (the `g`-prefixed device-resident
variants, cufhe_gates_gpu.cu:161-167, are the *default* here: host<->device
movement happens only at encrypt/decrypt).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import golden as G
from ..ops import bootstrap as B
from ..ops import keys as K
from ..rng import resolve_rng
from ..params import GateParams
from ..parallel import mesh as M
from .gates import GATE_CONSTANTS


@dataclasses.dataclass
class Ctxt:
    """A batch of TLWE ciphertexts at a given level (Ctxt<P>,
    cufhe_gpu.cuh:102-121 — but batched and device-resident)."""
    data: jnp.ndarray  # [B, dim+1] uint32
    level: int         # 0 (lvl0param) or 1 (lvl1param domain)

    @property
    def batch(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass
class TrlweCtxt:
    """Batch of TRLWE ciphertexts [B, k+1, N] (cuFHETRLWElvl1 analogue)."""
    data: jnp.ndarray


def encrypt_bits(bits: Sequence[int], sk: G.SecretKey,
                 rng: Optional[np.random.Generator] = None,
                 level: int = 0) -> Ctxt:
    """Encrypt a list/array of bits into a ciphertext batch (client side).
    One RNG draw + one matmul for the whole batch (encrypt_bit_batch).
    Default randomness is the OS CSPRNG (rng.SecureRandom); pass a seeded
    Generator only for reproducible tests."""
    rng = resolve_rng(rng=rng)
    return Ctxt(jnp.asarray(G.encrypt_bit_batch(bits, sk, rng, level=level)),
                level)


def decrypt_bits(ct: Ctxt, sk: G.SecretKey) -> np.ndarray:
    """Decrypt a ciphertext batch to a bit array (client side)."""
    data = np.asarray(jax.device_get(ct.data))
    return G.decrypt_bit_batch(data, sk, level=ct.level)


class Context:
    """Server-side evaluation context (Initialize(ek) analogue,
    cufhe_gates_gpu.cu:42-47).

    Converts the evaluation key to int8 limb form once, optionally replicates
    it across a mesh, and caches one jitted program per (gate, level, batch
    shape) — the XLA analogue of the reference's per-gate kernels.
    """

    def __init__(self, ek: G.EvalKey, backend: str = "auto",
                 mesh: Optional[object] = None):
        self.params: GateParams = ek.params
        self.backend = backend
        self.mesh = mesh
        resolved = B.resolve_backend(backend, ek.params)   # raises if unknown
        keys = K.prepare_keys(ek, backends=(resolved,))
        self.keys = M.replicate(keys, mesh) if mesh is not None else keys
        self._cache = {}
        self._dev_keys = {}

    # -- program construction -------------------------------------------
    def _shard(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.mesh is not None:
            return M.shard_batch(x, self.mesh)
        return x

    def _place(self, x: jnp.ndarray, stream) -> jnp.ndarray:
        """Stream-pinned placement (CtxtCopyH2D onto the stream's device,
        cufhe_gpu.cuh:193-199) or mesh sharding.

        Already-placed arrays pass through untouched: a chained gate's
        pending output stays where it is, with no copy and no wait for it
        to finish — chaining device-resident outputs is the Stream API's
        whole point (the reference chains g-gates the same way,
        cufhe_gates_gpu.cu:161-167)."""
        if stream is not None:
            devs = getattr(x, "devices", None)
            if callable(devs):
                try:
                    if devs() == {stream.device}:
                        return x
                except Exception:
                    pass
            return jax.device_put(x, stream.device)
        return self._shard(x)

    def _keys_for(self, stream):
        """Per-device key replica for stream dispatch — the reference
        uploads keys to every GPU at Initialize (bootstrap_gpu.cu:115-137);
        here replicas materialize lazily per stream device."""
        if stream is None:
            return self.keys
        if self.mesh is not None:
            raise ValueError("stream dispatch and mesh sharding are "
                             "mutually exclusive on one Context")
        dev = stream.device
        if dev not in self._dev_keys:
            # The Context's primary key set already lives on SOME device:
            # when the stream is pinned there (every single-device Stream),
            # reuse it rather than copy the key set onto the same device.
            leaves = jax.tree_util.tree_leaves(self.keys)
            on = getattr(leaves[0], "devices", None) if leaves else None
            if callable(on) and leaves[0].devices() == {dev}:
                self._dev_keys[dev] = self.keys
            else:
                self._dev_keys[dev] = jax.device_put(self.keys, dev)
        return self._dev_keys[dev]

    # Which DeviceKeys fields each backend's compute path consumes (the
    # unit of selective release/re-preparation). "ksk" = every gate's KSK.
    _BACKEND_KEY_FIELDS = {
        "conv": ("bk_filters",),
        "toeplitz": ("bk_limbs",),
        "ntt": ("bk_ntt", "bk_ntt_shoup"),
        "ksk": ("ksk_limbs", "ksk_limbs_sei"),
    }
    _KEY_PLACEHOLDER_DTYPES = {
        "bk_filters": np.int8, "bk_limbs": np.int8,
        "bk_ntt": np.uint32, "bk_ntt_shoup": np.uint32,
    }

    def release_keys(self, backends: Optional[Sequence[str]] = None) -> None:
        """Free device key material NOW (the DeleteBootstrappingKeyNTT /
        DeleteKeySwitchingKey analogue, bootstrap_gpu.cuh:50-165,
        keyswitch_gpu.cuh:190-196) instead of waiting for Python GC — a
        long-lived server swapping presets must not hold two key sets.

        backends=None frees everything (keyswitch keys included); or pass
        backend names to free selectively — e.g. ("toeplitz",) drops that
        backend's BK copy while conv gates stay live. Gates on a released
        backend fail until prepare_backend() restores it.
        """
        if backends is None:
            fields = {f.name for f in dataclasses.fields(self.keys)}
        else:
            fields = set()
            for b in backends:
                if b not in self._BACKEND_KEY_FIELDS:
                    raise ValueError(f"unknown backend {b!r}")
                fields |= set(self._BACKEND_KEY_FIELDS[b])
        # stream-device replicas hold their own buffers: always drop them
        for rep in self._dev_keys.values():
            for leaf in jax.tree_util.tree_leaves(rep):
                leaf.delete()
        self._dev_keys = {}
        updates = {}
        for name in fields:
            for leaf in jax.tree_util.tree_leaves(getattr(self.keys, name)):
                if leaf.size:
                    leaf.delete()
            dt = self._KEY_PLACEHOLDER_DTYPES.get(name)
            updates[name] = jnp.zeros(
                (0,), dtype=dt if dt is not None else
                getattr(self.keys, name).dtype)
        self.keys = dataclasses.replace(self.keys, **updates)

    def prepare_backend(self, ek: G.EvalKey, backend: str = "auto") -> None:
        """(Re-)materialize one backend's key format from the host
        EvalKey and merge it into this Context — the inverse of a
        selective release_keys(); also restores the keyswitch keys if a
        full release dropped them."""
        resolved = B.resolve_backend(backend, self.params)
        fresh = K.prepare_keys(ek, backends=(resolved,))
        if self.mesh is not None:
            fresh = M.replicate(fresh, self.mesh)
        names = set(self._BACKEND_KEY_FIELDS[resolved])
        if not self.keys.ksk_limbs.size:
            names |= set(self._BACKEND_KEY_FIELDS["ksk"])
        self.keys = dataclasses.replace(
            self.keys, **{n: getattr(fresh, n) for n in names})
        self.backend = backend

    def reinitialize(self, ek: G.EvalKey, backend: str = "auto") -> None:
        """Preset swap for a long-lived server: free every device key of
        the current parameter set, then initialize from a new EvalKey (may
        use different params). Compiled programs for the old set are
        dropped; ciphertexts from the old Context are invalid."""
        self.release_keys()
        self.params = ek.params
        self.backend = backend
        resolved = B.resolve_backend(backend, ek.params)
        keys = K.prepare_keys(ek, backends=(resolved,))
        self.keys = M.replicate(keys, self.mesh) \
            if self.mesh is not None else keys
        self._cache = {}
        self._dev_keys = {}

    def _jit(self, key, fn, batch_argnums=None):
        """jit `fn`; with a mesh and batch_argnums, first wrap it in
        shard_map over the data axis (replicated keys/constants), so each
        device runs the unpartitioned program on its batch shard."""
        if key not in self._cache:
            if self.mesh is not None and batch_argnums is not None:
                fn = M.data_parallel(fn, self.mesh, batch_argnums)
            self._cache[key] = jax.jit(fn)
        return self._cache[key]

    # -- two-input gates --------------------------------------------------
    def gate(self, name: str, in0: Ctxt, in1: Ctxt, stream=None) -> Ctxt:
        """Evaluate one of the 10 bootstrapped two-input gates on a batch.

        The gate's linear-combination constants are runtime uint32 operands,
        so all ten gates share ONE compiled program per (level, batch shape)
        — unlike the reference's per-gate template instantiations
        (bootstrap_gpu.cu:424-512), XLA need not re-specialize.
        """
        if name not in GATE_CONSTANTS:
            raise ValueError(f"unknown gate {name!r}; "
                             f"choose from {sorted(GATE_CONSTANTS)}")
        if in0.level != in1.level:
            raise ValueError("gate inputs must share a level")
        if in0.data.shape != in1.data.shape:
            raise ValueError(f"gate input batches differ: "
                             f"{in0.data.shape} vs {in1.data.shape}")
        level = in0.level
        p = self.params
        mu = p.lvl0.mu if level == 0 else p.lvl1.mu
        c3 = B.encode_gate_consts(GATE_CONSTANTS[name], mu)
        out = Ctxt(self.gate_program(level)(c3, self._place(in0.data, stream),
                        self._place(in1.data, stream),
                        self._keys_for(stream)), level)
        if stream is not None:
            stream.record(out)
        return out

    def gate_program(self, level: int = 0):
        """The jitted two-input gate program for `level`:
        (consts uint32[3], in0, in1, keys) -> out. Exposed so callers can
        lower and compile it ahead of time (chip_smoke.py reports its
        compile time and memory analysis)."""
        p, bk = self.params, self.backend
        fn = B.gate_lvl0 if level == 0 else B.gate_lvl1
        return self._jit(("gate", level),
                         lambda c, a, b, keys: fn(c, a, b, keys=keys,
                                                  params=p, backend=bk),
                         batch_argnums=(1, 2))

    def gate_rows(self, c3_rows: jnp.ndarray, in0: Ctxt, in1: Ctxt) -> Ctxt:
        """Heterogeneous two-input gate batch: row i of `c3_rows`
        ([G, 3] uint32 from encode_gate_consts_rows) selects gate i's
        linear-combination constants. One compiled program per (level,
        batch shape) evaluates ANY mix of the ten gates — the executor
        fuses a whole circuit level into one call with this.

        c3_rows may be [G, 3] with G dividing the ciphertext batch
        (gate-major layout): it is tiled on device inside the program, so
        the host transfers G rows instead of G*B."""
        level = in0.level
        p, bk = self.params, self.backend
        fn = B.gate_lvl0 if level == 0 else B.gate_lvl1

        def run(c, a, b, keys):
            if c.shape[0] != a.shape[0]:
                c = jnp.repeat(c, a.shape[0] // c.shape[0], axis=0)
            return fn(c, a, b, keys=keys, params=p, backend=bk)

        c3 = jnp.asarray(c3_rows)
        if self.mesh is not None and c3.shape[0] != in0.data.shape[0]:
            # per-row constants must shard WITH the batch axis: tile to
            # full gate-major [G*B, 3] before shard_map splits axis 0
            # (leaving them [G, 3] would shard the gate list itself)
            c3 = jnp.repeat(c3, in0.data.shape[0] // c3.shape[0], axis=0)
        prog = self._jit(("gate_rows", level), run, batch_argnums=(0, 1, 2))
        return Ctxt(prog(c3, self._shard(in0.data),
                         self._shard(in1.data), self.keys), level)

    def gate_chain(self, name, in0: Ctxt, in1: Ctxt,
                   depth: Optional[int] = None, stream=None) -> Ctxt:
        """Dependent gate chain fused on device: out = gate(out, in1)
        applied repeatedly inside ONE compiled program (lax.scan over the
        bootstrap), so a whole chain costs one dispatch — the reference's
        device-resident g-gate chaining (cufhe_gates_gpu.cu:161-167) with
        the driving loop moved onto the device.

        `name` is either a single gate name (applied `depth` times) or a
        sequence of names, one per step (the scan carries per-step gate
        constants, so ANY mix of the ten gates shares one compiled program
        per (level, depth, batch)). The scan body is traced once, so
        compile cost matches a single gate. Bit-identical to the same
        sequence of separate gate() calls."""
        if isinstance(name, str):
            if depth is None:
                raise ValueError("depth is required with a single gate name")
            names = [name] * depth
        else:
            names = list(name)
            if depth is not None and depth != len(names):
                raise ValueError("depth disagrees with the gate-name "
                                 "sequence")
        if not names:
            raise ValueError("chain needs at least one gate")
        for nm in names:
            if nm not in GATE_CONSTANTS:
                raise ValueError(f"unknown gate {nm!r}")
        if in0.level != in1.level:
            raise ValueError("gate inputs must share a level")
        level = in0.level
        p, bk = self.params, self.backend
        mu = p.lvl0.mu if level == 0 else p.lvl1.mu
        c3s = B.encode_gate_consts_rows(names, mu)        # [depth, 3]
        fn = B.gate_lvl0 if level == 0 else B.gate_lvl1

        def run(cs, a, b, keys):
            def body(acc, c):
                return fn(c, acc, b, keys=keys, params=p, backend=bk), None
            out, _ = jax.lax.scan(body, a, cs)
            return out

        prog = self._jit(("gate_chain", level, len(names)), run,
                         batch_argnums=(1, 2))
        out = Ctxt(prog(jnp.asarray(c3s), self._place(in0.data, stream),
                        self._place(in1.data, stream),
                        self._keys_for(stream)), level)
        if stream is not None:
            stream.record(out)
        return out

    def mux(self, inc: Ctxt, in1: Ctxt, in0: Ctxt,
            negate: bool = False, stream=None) -> Ctxt:
        """Mux(inc ? in1 : in0) / NMux — two blind rotations
        (bootstrap_gpu.cu:514-588)."""
        if not (inc.level == in1.level == in0.level):
            raise ValueError("mux inputs must share a level")
        level = inc.level
        p, bk = self.params, self.backend
        fn = B.mux_lvl0 if level == 0 else B.mux_lvl1
        prog = self._jit(("mux", level, negate),
                         lambda c, x1, x0, keys: fn(c, x1, x0, keys, p,
                                                    negate=negate,
                                                    backend=bk),
                         batch_argnums=(0, 1, 2))
        out = Ctxt(prog(self._place(inc.data, stream),
                        self._place(in1.data, stream),
                        self._place(in0.data, stream),
                        self._keys_for(stream)), level)
        if stream is not None:
            stream.record(out)
        return out

    def nmux(self, inc: Ctxt, in1: Ctxt, in0: Ctxt, stream=None) -> Ctxt:
        return self.mux(inc, in1, in0, negate=True, stream=stream)

    # -- linear gates -------------------------------------------------------
    def not_(self, ct: Ctxt, stream=None) -> Ctxt:
        prog = self._jit(("not",), B.not_gate)
        out = Ctxt(prog(self._place(ct.data, stream)), ct.level)
        if stream is not None:
            stream.record(out)
        return out

    def copy(self, ct: Ctxt, stream=None) -> Ctxt:
        out = Ctxt(self._place(ct.data, stream) if stream is not None
                   else ct.data, ct.level)
        if stream is not None:
            stream.record(out)
        return out

    # -- TRLWE / TRGSW path ---------------------------------------------
    def prepare_trgsw(self, trgsw: np.ndarray) -> dict:
        """TRGSW2NTT analogue (bootstrap_gpu.cu:75-94)."""
        return K.prepare_trgsw(trgsw, self.params)

    def cmux(self, trgsw_dev: dict, c1: TrlweCtxt, c0: TrlweCtxt) -> TrlweCtxt:
        prog = self._jit(("cmux",),
                         lambda x1, x0, tg: B.cmux(tg, x1, x0, self.params,
                                                   self.backend),
                         batch_argnums=(0, 1))
        return TrlweCtxt(prog(c1.data, c0.data, trgsw_dev))

    def refresh(self, tr: TrlweCtxt) -> TrlweCtxt:
        prog = self._jit(("refresh",),
                         lambda x, keys: B.refresh(x, keys, self.params,
                                                   self.backend),
                         batch_argnums=(0,))
        return TrlweCtxt(prog(tr.data, self.keys))

    def bootstrap_tlwe2trlwe(self, ct: Ctxt, mu: Optional[int] = None
                             ) -> TrlweCtxt:
        mu = self.params.lvl1.mu if mu is None else mu
        prog = self._jit(("b2t", mu),
                         lambda x, keys: B.bootstrap_tlwe2trlwe(
                             x, mu, keys, self.params, self.backend),
                         batch_argnums=(0,))
        return TrlweCtxt(prog(self._shard(ct.data), self.keys))

    def pbs_tlwe2trlwe(self, ct: Ctxt, tv) -> TrlweCtxt:
        """Programmable bootstrap, TLWE -> TRLWE: blind-rotate a CUSTOM
        test polynomial `tv` ([N] uint32) by the input phase. Beyond the
        reference's capability set (its test vector is pinned to the
        constant mu); runs on the same kernels."""
        tv = jnp.asarray(tv)
        # a per-batch tv ([B, N]) must shard with the batch under a mesh
        prog = self._jit(("pbs", tv.ndim),
                         lambda x, t, keys: B.pbs_tlwe2trlwe(
                             x, t, keys, self.params, self.backend),
                         batch_argnums=(0, 1) if tv.ndim == 2 else (0,))
        return TrlweCtxt(prog(self._shard(ct.data),
                              self._shard(tv) if tv.ndim == 2 else tv,
                              self.keys))

    def programmable_bootstrap(self, ct: Ctxt, tv) -> Ctxt:
        """Full programmable (functional) bootstrap: custom-test-vector
        blind rotation, sample extract, keyswitch back to lvl0. The output
        encrypts tv[w] (negacyclically -tv[w - N]) where w is the
        modswitched phase window of the input."""
        tv = jnp.asarray(tv)
        prog = self._jit(("pbs_full", tv.ndim),
                         lambda x, t, keys: B.programmable_bootstrap(
                             x, t, keys, self.params, self.backend),
                         batch_argnums=(0, 1) if tv.ndim == 2 else (0,))
        return Ctxt(prog(self._shard(ct.data),
                         self._shard(tv) if tv.ndim == 2 else tv,
                         self.keys), 0)

    def sample_extract_and_keyswitch(self, tr: TrlweCtxt) -> Ctxt:
        prog = self._jit(("seiks",),
                         lambda x, keys: B.sei_and_ks(x, keys, self.params),
                         batch_argnums=(0,))
        return Ctxt(prog(tr.data, self.keys), 0)

    # -- named gate shorthands (the reference's public gate list) ---------
    def nand(self, a, b, stream=None): return self.gate("nand", a, b, stream=stream)
    def nor(self, a, b, stream=None): return self.gate("nor", a, b, stream=stream)
    def xnor(self, a, b, stream=None): return self.gate("xnor", a, b, stream=stream)
    def and_(self, a, b, stream=None): return self.gate("and", a, b, stream=stream)
    def or_(self, a, b, stream=None): return self.gate("or", a, b, stream=stream)
    def xor(self, a, b, stream=None): return self.gate("xor", a, b, stream=stream)
    def and_ny(self, a, b, stream=None): return self.gate("andny", a, b, stream=stream)
    def and_yn(self, a, b, stream=None): return self.gate("andyn", a, b, stream=stream)
    def or_ny(self, a, b, stream=None): return self.gate("orny", a, b, stream=stream)
    def or_yn(self, a, b, stream=None): return self.gate("oryn", a, b, stream=stream)
