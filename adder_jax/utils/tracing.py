"""Per-stage tracing / profiling surface.

The reference has only ad-hoc `Instant` prints (SURVEY section 5: ADU
decompression ns in compressed/stream.rs:393-409, simulproc ms/frame,
adder-viz runtime plots). This module is the structured equivalent:

- `stage(name)`: context manager accumulating wall time + call counts per
  stage into a process-global registry (thread-safe).
- `report()` / `summary_table()`: snapshot of per-stage totals, means, and
  rates.
- `device_trace(dir)`: jax.profiler trace context (the device timeline in
  TensorBoard format) for kernel-level inspection, and
  `device_trace_summary(dir)`, which reduces such a trace to the device's
  busy share and its kernels' times.

Enable with ADDER_TRACE=1 (stages become no-ops otherwise, so the hot
path pays one dict lookup only); `tools/adder_simulproc.py --trace` and
the Video pipeline use it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

_ENABLED = os.environ.get("ADDER_TRACE", "0") not in ("", "0")
_LOCK = threading.Lock()


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    items: int = 0  # optional unit count (pixels, events, bytes)

    @property
    def mean_ms(self) -> float:
        return self.total_s / self.calls * 1e3 if self.calls else 0.0


_REGISTRY: Dict[str, StageStats] = {}


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = on


@contextlib.contextmanager
def stage(name: str, items: int = 0):
    """Accumulate wall time under `name`; `items` adds to a unit counter
    so report() can derive rates (px/s, events/s)."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            s = _REGISTRY.setdefault(name, StageStats())
            s.calls += 1
            s.total_s += dt
            s.max_s = max(s.max_s, dt)
            s.items += items


def add_items(name: str, items: int) -> None:
    if not _ENABLED:
        return
    with _LOCK:
        _REGISTRY.setdefault(name, StageStats()).items += items


def report() -> Dict[str, StageStats]:
    with _LOCK:
        return {k: StageStats(**vars(v)) for k, v in _REGISTRY.items()}


def reset() -> None:
    with _LOCK:
        _REGISTRY.clear()


def summary_table() -> str:
    rows = ["stage                          calls   total_ms   mean_ms     rate"]
    for name, s in sorted(report().items(), key=lambda kv: -kv[1].total_s):
        rate = (
            f"{s.items / s.total_s / 1e6:8.2f}M/s" if s.items and s.total_s
            else "        -"
        )
        rows.append(
            f"{name:<30} {s.calls:>5} {s.total_s*1e3:>10.1f}"
            f" {s.mean_ms:>9.2f} {rate}"
        )
    return "\n".join(rows)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """jax.profiler trace (TensorBoard format) around a region; no-op when
    log_dir is None."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_trace_summary(log_dir: str, top: int = 12) -> dict:
    """Reduce the newest jax.profiler trace under `log_dir` to device
    metrics. Kernel and copy events are read from the GPU planes' stream
    lines; the window runs from the first to the last of them. Returns
    {"window_ms", "busy_ms", "busy_share", "copy_ms": {direction: ms},
    "kernels": [(name, ms, count), ...] (the `top` longest by total)}."""
    import glob
    import os

    import jax

    paths = glob.glob(
        os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True
    )
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb trace under {log_dir}")
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    spans, totals, counts, copies = [], {}, {}, {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.end_ns))
                name = ev.name
                low = name.lower()
                if "memcpy" in low:
                    kind = (
                        "d2h" if ("dtoh" in low or "d2h" in low)
                        else "h2d" if ("htod" in low or "h2d" in low)
                        else "d2d"
                    )
                    copies[kind] = copies.get(kind, 0.0) + ev.duration_ns
                totals[name] = totals.get(name, 0.0) + ev.duration_ns
                counts[name] = counts.get(name, 0) + 1
    if not spans:
        raise ValueError(f"trace under {log_dir} holds no GPU stream events")
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "busy_share": busy / window if window else 0.0,
        "copy_ms": {k: v / 1e6 for k, v in copies.items()},
        "kernels": [(k, v / 1e6, counts[k]) for k, v in ranked],
    }
