"""Stream-style async API parity shim.

The reference exposes Stream (one CUDA stream pinned to a GPU,
cufhe_gpu.cuh:152-189), StreamQuery (non-blocking completion poll,
cufhe_gates_gpu.cu:55-65) and Synchronize (device sweep, cufhe_gpu.cuh:68-74).
JAX dispatch is already asynchronous: every gate call returns immediately
with futures for device buffers, so a Stream here is just an ordered lane of
in-flight results — the object exists so code written against the reference's
completion-polling pattern (test_intensive.cc:21-54) ports directly.
"""
from __future__ import annotations

import weakref
from typing import List, Optional

import jax

#: Live streams, for the global Synchronize() sweep (cufhe_gpu.cuh:68-74
#: loops all devices; here we drain every lane that still has work).
_live: "weakref.WeakSet[Stream]" = weakref.WeakSet()


class Stream:
    """An ordered lane of asynchronously dispatched gate results, pinned to
    one device. Passing a Stream to a Context gate places the inputs (and a
    per-device replica of the keys) on `stream.device` and records the
    output here — the reference's round-robin multi-GPU dispatch
    (cufhe_gpu.cuh:152-189) with real placement semantics."""

    _count = 0

    def __init__(self, device: Optional[object] = None):
        # round-robin device assignment, mirroring streamCount % _gpuNum
        # (reference cufhe_gpu.cuh:154-158)
        devs = jax.devices()
        self.device = device if device is not None else \
            devs[Stream._count % len(devs)]
        Stream._count += 1
        self._pending: List[object] = []
        _live.add(self)

    def record(self, *cts) -> None:
        """Track ciphertexts produced on this stream (gate outputs)."""
        self._pending.extend(ct.data if hasattr(ct, "data") else ct
                             for ct in cts)

    def query(self) -> bool:
        """StreamQuery analogue: True iff all recorded work has completed
        on device (non-blocking)."""
        for arr in self._pending:
            ready = arr.is_ready() if hasattr(arr, "is_ready") else True
            if not ready:
                return False
        self._pending.clear()
        return True

    def synchronize(self) -> None:
        """Block until everything recorded on this stream is complete."""
        for arr in self._pending:
            jax.block_until_ready(arr)
        self._pending.clear()


def stream_query(stream: Stream) -> bool:
    """Free-function form of the reference's StreamQuery."""
    return stream.query()


def synchronize(*streams: Stream) -> None:
    """Synchronize() analogue: with no arguments, drain every live stream's
    recorded work; with streams, drain those lanes. (JAX has no global
    device barrier — a fresh device_put is NOT ordered behind previously
    dispatched computations — so the global form is defined over the work
    actually recorded on Stream lanes.)"""
    for st in streams if streams else list(_live):
        st.synchronize()
