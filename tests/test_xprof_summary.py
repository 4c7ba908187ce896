"""Unit tests for tools/xprof_summary.py — the `pano.sh perf` report stage
(the analog of the reference's `perf report --stdio`,
reference pano.sh:231-235).

The reductions are checked on small stand-in planes shaped like
jax.profiler.ProfileData's (a GPU plane carries one line per stream), and
the reader on a trace recorded here on the CPU backend.
"""

import io
import os
import sys
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools")
)

import xprof_summary  # noqa: E402

MS = 1e6  # ns


def _event(name, start_ms, dur_ms):
    return SimpleNamespace(name=name, start_ns=start_ms * MS,
                           duration_ns=dur_ms * MS, stats=[])


def _gpu_space():
    """A GPU plane with two stream lines whose events overlap in time, and
    a host plane that the device reductions must skip."""
    compute = SimpleNamespace(name="Stream #13(Compute)", events=[
        _event("fusion.1", 0, 10), _event("fusion.1", 2, 3),
        _event("custom-call.7", 20, 5),
    ])
    copies = SimpleNamespace(name="Stream #14(MemcpyD2H)", events=[
        _event("MemcpyD2H", 8, 4),      # overlaps fusion.1 by 2 ms
        _event("MemcpyD2H", 30, 1),
    ])
    gpu = SimpleNamespace(name="/device:GPU:0", lines=[compute, copies])
    host = SimpleNamespace(name="/host:CPU", lines=[SimpleNamespace(
        name="python", events=[_event("$main", 0, 100)])])
    return SimpleNamespace(planes=[gpu, host])


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 10), (2, 5)], 10.0),             # nested
    ([(0, 10), (20, 25)], 15.0),           # disjoint
    ([(0, 10), (10, 12), (11, 15)], 15.0),  # touching and chained
])
def test_union_ns(spans, want):
    assert xprof_summary.union_ns(spans) == want


def test_gpu_busy_is_union_across_stream_lines():
    """Busy = union over all stream lines: [0,12] + [20,25] + [30,31]."""
    pd = _gpu_space()
    gpu = xprof_summary.device_planes(pd)
    assert [p.name for p in gpu] == ["/device:GPU:0"]
    assert xprof_summary.plane_busy_ns(gpu[0]) == 18 * MS
    assert xprof_summary.plane_window_ns(gpu[0]) == 31 * MS
    assert xprof_summary.device_busy_ms(pd) == pytest.approx(18.0)


def test_busy_inside_a_host_window():
    """A host span [5, 22] clips the device events to [5,12] + [20,22]."""
    pd = _gpu_space()
    pd.planes[1].lines[0].events.append(_event("steady_window", 5, 17))
    t0, t1 = xprof_summary.host_span_ns(pd, "steady_window")
    assert (t0, t1) == (5 * MS, 22 * MS)
    assert xprof_summary.device_busy_in_ms(pd, t0, t1) == pytest.approx(9.0)
    assert xprof_summary.device_busy_in_ms(pd, 0, 100 * MS) == pytest.approx(
        xprof_summary.device_busy_ms(pd))
    with pytest.raises(KeyError):
        xprof_summary.host_span_ns(pd, "fusion.1")   # a device event only


def test_op_table_and_summary():
    pd = _gpu_space()
    table = xprof_summary.op_table(pd.planes[0])
    assert table["fusion.1"] == (13 * MS, 2)
    assert table["custom-call.7"] == (5 * MS, 1)
    assert table["MemcpyD2H"] == (5 * MS, 2)
    out = io.StringIO()
    with redirect_stdout(out):
        xprof_summary.summarize(pd, top=10)
    text = out.getvalue()
    assert "/device:GPU:0  busy=18.000 ms  window=31.000 ms" in text
    assert "/host:CPU" not in text
    assert "Stream #14(MemcpyD2H)  events=2  busy=5.000 ms" in text


def test_summary_truncates_long_kernel_names():
    long = "void cub::DeviceRadixSortOnesweepKernel<" + "x" * 300 + ">"
    line = SimpleNamespace(name="s", events=[_event(long, 0, 1)])
    pd = SimpleNamespace(planes=[
        SimpleNamespace(name="/device:GPU:0", lines=[line])])
    out = io.StringIO()
    with redirect_stdout(out):
        xprof_summary.summarize(pd)
    rows = [r for r in out.getvalue().splitlines() if "cub::" in r]
    assert rows and all(len(r) < xprof_summary.NAME_WIDTH + 40 for r in rows)


def test_recorded_cpu_trace(tmp_path):
    """A trace recorded here: find_pb locates the xplane file, load reads
    it with jax.profiler.ProfileData, and the summary falls back to the
    host planes because the CPU backend writes no device plane."""
    f = jax.jit(lambda x: jnp.sin(x) @ x.T)
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path / "trace")):
        with jax.profiler.TraceAnnotation("steady_window"):
            f(x).block_until_ready()
    pb = xprof_summary.find_pb(str(tmp_path))
    assert pb.endswith(".xplane.pb")
    assert xprof_summary.find_pb(pb) == pb
    pd = xprof_summary.load(pb)
    assert xprof_summary.device_planes(pd) == []
    assert xprof_summary.device_busy_ms(pd) == 0.0
    t0, t1 = xprof_summary.host_span_ns(pd, "steady_window")
    assert t1 > t0
    assert xprof_summary.device_busy_in_ms(pd, t0, t1) == 0.0
    out = io.StringIO()
    with redirect_stdout(out):
        xprof_summary.summarize(pd, top=5)
    assert "no device plane in trace" in out.getvalue()
    assert "=== plane:" in out.getvalue()


def test_find_pb_without_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        xprof_summary.find_pb(str(tmp_path))
