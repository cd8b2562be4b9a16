"""The port's perf utilities (figdraw_tpu_torch/utils/perf.py): the twins
of tests/test_misc.py's test_perf_buffer_and_timeseries and
test_heap_diff_reporter, the perf buffer against figdraw_tpu's on the
same entries, and render_frame's spans under figdraw_tpu's tag names."""

import inspect

import pytest
import torch

import figdraw_tpu_torch as port
from figdraw_tpu.utils import perf as jperf
from figdraw_tpu_torch.scenes import make_render_tree_array
from figdraw_tpu_torch.utils import perf as pperf

torch.set_num_threads(1)


def test_perf_buffer_and_timeseries():
    from figdraw_tpu_torch.utils.perf import FrameStats, PerfBuffer, TimeSeries, perf, time_it

    buf = PerfBuffer()
    with perf("frame", buf):
        with perf("flatten", buf):
            pass
        with perf("raster", buf):
            pass
    dump = buf.dump()
    assert "frame" in dump and "flatten" in dump and "raster" in dump
    assert dump.index("  flatten") < dump.index("frame:")

    ts = TimeSeries(window=10.0)
    for _ in range(5):
        ts.tick()
    assert ts.rate() == pytest.approx(0.5, rel=0.2)

    stats = FrameStats()
    for v in (1.0, 2.0, 3.0, 10.0):
        stats.add(v)
    s = stats.summary()
    assert s["min_ms"] == 1.0 and s["max_ms"] == 10.0
    assert s["avg_ms"] == 4.0

    _result, dt = time_it(lambda: sum(range(100)))
    assert dt >= 0


def test_heap_diff_reporter():
    from figdraw_tpu_torch.utils.perf import dump_heap_diff, heap_snapshot, rss_bytes

    assert rss_bytes() > 10 * 1024 * 1024  # a live CPython process is >10MB
    snap = heap_snapshot()
    assert snap["rss"] > 0 and snap["objects"] > 0
    ballast = [[i] for i in range(50_000)]
    msg = dump_heap_diff(snap, label="unit", frames=1000)
    assert "heapDiff unit" in msg
    assert "rss=" in msg and "objects=" in msg and "drift=" in msg
    cur = heap_snapshot()
    assert cur["objects"] - snap["objects"] > 40_000
    del ballast


def test_dump_equals_figdraw_tpus_on_the_same_entries():
    """The same begin/end/mark entries (times included) print the same
    nested dump; summaries and key-value lines match too."""
    pb, jb = pperf.PerfBuffer(), jperf.PerfBuffer()
    entries = [("frame", "begin", 1.0), ("messages", "begin", 1.001),
               ("messages", "end", 1.002), ("x", "mark", 1.0025),
               ("flatten", "begin", 1.003), ("flatten", "end", 1.0071),
               ("stray", "end", 1.008), ("frame", "end", 1.0125)]
    for tag, kind, t in entries:
        pb.entries.append(pperf._PerfEntry(tag, kind, t))
        jb.entries.append(jperf._PerfEntry(tag, kind, t))
    assert pb.dump() == jb.dump()
    samples = [3.0, 1.5, 9.25, 2.0, 4.0]
    ps, js = pperf.FrameStats(), jperf.FrameStats()
    for v in samples:
        ps.add(v)
        js.add(v)
    assert ps.summary() == js.summary()


def test_buffer_capacity_and_disable():
    buf = pperf.PerfBuffer(capacity=4)
    for i in range(5):
        with pperf.perf(f"s{i}", buf):
            pass
    assert len(buf.entries) == 4
    buf.clear()
    buf.enabled = False
    pperf.perf_mark("m", buf)
    assert buf.entries == []


def test_log_kv_formats_key_values(caplog):
    import logging

    with caplog.at_level(logging.WARNING, logger="figdraw_tpu_torch"):
        pperf.log_kv(logging.WARNING, "atlas grew", size=2048, reason="image")
        pperf.log_kv(logging.DEBUG, "dropped")
    assert [r.getMessage() for r in caplog.records] == ["atlas grew size=2048 reason=image"]


def _spans(entries):
    """(tag, depth, ms) of each closed span, in order of closing."""
    out, stack = [], []
    for e in entries:
        if e.kind == "begin":
            stack.append(e)
        elif e.kind == "end":
            b = stack.pop()
            assert b.tag == e.tag
            out.append((e.tag, len(stack), (e.t - b.t) * 1e3))
    return out


def test_render_frame_records_its_four_spans():
    """render_frame: `frame` around `messages`, `flatten` and `execute`, in
    that order, on the global buffer perf_dump prints; nothing for an empty
    frame size."""
    ren = port.FigRenderer(device="cpu")
    scene = make_render_tree_array(192, 108, 0, copies=4)
    buf = pperf._global_perf
    buf.clear()
    try:
        ren.render_frame(scene, port.vec2(192, 108))
        ren.render_frame(scene, port.vec2(0, 108))
        spans = _spans(buf.entries)
        dump = pperf.perf_dump()
    finally:
        buf.clear()
    assert [(t, d) for t, d, _ms in spans] == [
        ("messages", 1), ("flatten", 1), ("execute", 1), ("frame", 0)]
    frame_ms = spans[-1][2]
    assert all(0 <= ms <= frame_ms for _t, _d, ms in spans)
    for tag in ("frame:", "  messages:", "  flatten:", "  execute:"):
        assert tag in dump


def test_render_frame_spans_read_the_host_clock_only():
    """The spans stall nothing: render_frame's body synchronizes no device
    and reads no tensor back."""
    src = inspect.getsource(port.FigRenderer.render_frame)
    for word in ("synchronize", ".item(", ".cpu(", ".tolist(", "numpy("):
        assert word not in src
