"""Tracing / profiling utilities (figdraw_tpu/utils/perf.py, copied: the
port may not import the JAX package).

Counterpart of the reference's opengl/perf.nim: `perf(tag)` begin/end
entries on a monotonic buffer with a nested pretty-printer, `perf_mark`,
`time_it`, a `TimeSeries` FPS counter, and structured key-value logging
helpers (the reference uses chronicles; this uses stdlib logging with a
key=value formatter).

`FigRenderer.render_frame` records its spans on the global buffer under
figdraw_tpu's tags (renderer.render_frame). Spans read the host clock
only: none synchronizes the device or reads a tensor, so a span around an
asynchronous CUDA frame times its enqueue, not its device work.

`log_kv`: every warning figdraw_tpu logs through it is a step of its
fallback chain (a failed Pallas, mega, batched or sharded executor
downgraded to XLA: figdraw_tpu/renderer.py:1211, :1250, :1728, :2026,
:2116; parallel/sharding.py:578, :609, :857). The port has no fallback
chain, so none of those sites has a counterpart: a failed kernel raises
to the caller.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("figdraw_tpu_torch")


def log_kv(level: int, msg: str, **kv) -> None:
    """chronicles-style structured line: `msg key=value ...`"""
    if logger.isEnabledFor(level):
        suffix = " ".join(f"{k}={v}" for k, v in kv.items())
        logger.log(level, f"{msg} {suffix}" if suffix else msg)


@dataclass
class _PerfEntry:
    tag: str
    kind: str  # "begin" | "end" | "mark"
    t: float


class PerfBuffer:
    """Begin/end entries on a monotonic clock (perf.nim:36-120)."""

    def __init__(self, capacity: int = 4096):
        self.entries: List[_PerfEntry] = []
        self.capacity = capacity
        self.enabled = True

    def begin(self, tag: str) -> None:
        if self.enabled and len(self.entries) < self.capacity:
            self.entries.append(_PerfEntry(tag, "begin", time.perf_counter()))

    def end(self, tag: str) -> None:
        if self.enabled and len(self.entries) < self.capacity:
            self.entries.append(_PerfEntry(tag, "end", time.perf_counter()))

    def mark(self, tag: str) -> None:
        if self.enabled and len(self.entries) < self.capacity:
            self.entries.append(_PerfEntry(tag, "mark", time.perf_counter()))

    def clear(self) -> None:
        self.entries.clear()

    def dump(self) -> str:
        """Nested pretty-printer (perf.nim:122-180)."""
        lines: List[str] = []
        stack: List[Tuple[str, float]] = []
        for e in self.entries:
            indent = "  " * len(stack)
            if e.kind == "begin":
                stack.append((e.tag, e.t))
            elif e.kind == "end":
                while stack and stack[-1][0] != e.tag:
                    stack.pop()
                if stack:
                    tag, t0 = stack.pop()
                    indent = "  " * len(stack)
                    lines.append(f"{indent}{tag}: {(e.t - t0) * 1000:.3f} ms")
            else:
                lines.append(f"{indent}@ {e.tag}")
        return "\n".join(lines)


_global_perf = PerfBuffer()


@contextmanager
def perf(tag: str, buffer: Optional[PerfBuffer] = None):
    """`with perf("frame"):` — the reference's perf(tag) template."""
    buf = buffer or _global_perf
    buf.begin(tag)
    try:
        yield
    finally:
        buf.end(tag)


def perf_mark(tag: str, buffer: Optional[PerfBuffer] = None) -> None:
    (buffer or _global_perf).mark(tag)


def perf_dump(buffer: Optional[PerfBuffer] = None) -> str:
    return (buffer or _global_perf).dump()


def time_it(fn, *args, **kwargs):
    """Returns (result, elapsed_seconds)."""
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    return result, time.perf_counter() - t0


class TimeSeries:
    """Sliding-window event counter, e.g. FPS (perf.nim:182-216)."""

    def __init__(self, window: float = 1.0, max_events: int = 1024):
        self.window = window
        self.events: List[float] = []
        self.max_events = max_events

    def tick(self, t: Optional[float] = None) -> None:
        now = time.perf_counter() if t is None else t
        self.events.append(now)
        cutoff = now - self.window
        # drop expired from the front
        i = 0
        while i < len(self.events) and self.events[i] < cutoff:
            i += 1
        if i:
            del self.events[:i]
        if len(self.events) > self.max_events:
            del self.events[: len(self.events) - self.max_events]

    def rate(self) -> float:
        """Events per second over the window."""
        if not self.events:
            return 0.0
        now = time.perf_counter()
        live = [e for e in self.events if e >= now - self.window]
        return len(live) / self.window


def rss_bytes() -> int:
    """Current resident set size of this process, in bytes (0 if unknown)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource

        # ru_maxrss is KiB on Linux: a high-water mark, not current, where
        # /proc is absent
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


def heap_snapshot() -> Dict[str, float]:
    """Host memory snapshot: the dumpHeapDiff analog (perf.nim:200-216,
    which diffs Nim GC occupied/free/total). Python has no moving GC, so
    this tracks RSS plus the object count as the 'occupied' proxy."""
    import gc

    return {
        "t": time.perf_counter(),
        "rss": float(rss_bytes()),
        "objects": float(len(gc.get_objects())),
    }


def dump_heap_diff(prev: Dict[str, float], label: str = "", frames: int = 0) -> str:
    """Format the growth since `prev` (a heap_snapshot()). If `frames` is
    given, also normalizes to MB per 1k frames, the growth rate a frame loop
    leaks at."""
    cur = heap_snapshot()
    drss = cur["rss"] - prev["rss"]
    dobj = cur["objects"] - prev["objects"]
    dt = cur["t"] - prev["t"]
    parts = [
        f"heapDiff {label}".strip(),
        f"rss={cur['rss'] / 1e6:.1f}MB ({drss / 1e6:+.1f}MB)",
        f"objects={int(cur['objects'])} ({int(dobj):+d})",
        f"dt={dt:.1f}s",
    ]
    if frames > 0:
        parts.append(f"drift={drss / 1e6 / frames * 1000.0:+.2f}MB/1kframes")
    return " ".join(parts)


@dataclass
class FrameStats:
    """avg/p50/p95/min/max/fps summary like windy_clip_mask_benchmark.nim:207-275."""

    samples_ms: List[float] = field(default_factory=list)

    def add(self, ms: float) -> None:
        self.samples_ms.append(ms)

    def summary(self) -> Dict[str, float]:
        import numpy as np

        if not self.samples_ms:
            return {}
        arr = np.asarray(self.samples_ms)
        avg = float(arr.mean())
        return {
            "avg_ms": avg,
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "min_ms": float(arr.min()),
            "max_ms": float(arr.max()),
            "fps": 1000.0 / avg if avg > 0 else 0.0,
        }
