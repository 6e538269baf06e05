"""Reduce a JAX profiler trace to device metrics: kernels, busy and idle.

    python benchmarks/trace_summary.py <trace_dir> [plane_prefix]

Reads the newest `.xplane.pb` under `trace_dir` (as `jax.profiler.trace`
writes it) and, for the planes whose name starts with `plane_prefix`
(default "/device:GPU"), reports the number of device events, the busy
time (union of the event intervals), the window (first start to last end)
and the idle share, 1 - busy / window, with the gaps between busy
intervals. XLA's summary lines ("XLA Modules", "XLA Ops", ...) duplicate
the kernel events and are left out.
"""
from __future__ import annotations

import glob
import json
import os
import sys
from collections import Counter

_SUMMARY_LINES = ("XLA Modules", "XLA Ops", "XLA TraceMe", "Source",
                  "Steps", "Launch Stats", "TensorFlow Name Scope",
                  "TensorFlow Ops")


def newest_xplane(trace_dir: str) -> str:
    files = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(files, key=os.path.getmtime)


def device_events(path: str, plane_prefix: str = "/device:GPU") -> list:
    """[(name, start_ns, end_ns)] of every event on the matching planes,
    summary lines excluded."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if line.name.startswith(_SUMMARY_LINES):
                continue
            for ev in line.events:
                out.append((ev.name, float(ev.start_ns), float(ev.end_ns)))
    return out


def summarize(events: list, top: int = 8) -> dict:
    """Busy/idle reduction of [(name, start_ns, end_ns)] events."""
    if not events:
        return {"events": 0}
    ivs = sorted((s, e) for _, s, e in events)
    busy = 0.0
    gaps = []
    cur_s, cur_e = ivs[0]
    for s, e in ivs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append(s - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in ivs) - ivs[0][0]
    by_name = Counter()
    for name, s, e in events:
        by_name[name] += e - s
    return {
        "events": len(events),
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": (1.0 - busy / window) if window > 0 else 0.0,
        "gaps": len(gaps),
        "mean_gap_us": (sum(gaps) / len(gaps) / 1e3) if gaps else 0.0,
        "top_kernels_ms": [(n, t / 1e6) for n, t in by_name.most_common(top)],
    }


def main(argv: list) -> int:
    prefix = argv[2] if len(argv) > 2 else "/device:GPU"
    path = newest_xplane(argv[1])
    print(json.dumps(summarize(device_events(path, prefix))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
