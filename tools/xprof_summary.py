#!/usr/bin/env python3
"""Summarize a JAX profiler trace: device busy time and per-op device time.

The reference profiles with `perf record` + flamegraphs
(reference pano.sh:215-244); here the trace is the JAX profiler's
xplane dump (`pano.sh perf` / PANO_PROFILE=<dir>), read with
jax.profiler.ProfileData — nothing but JAX is needed.

Usage:
  python tools/xprof_summary.py <trace_dir_or_xplane.pb> [--top 30]
      [--by-line]

Device planes are the ones named /device:*. A GPU plane carries one line
per stream, and ops on different streams can overlap, so a plane's busy
time is the UNION of its events' intervals across all lines. Per-op time
sums each op name's event durations.
"""

import argparse
import collections
import glob
import os
import sys
from typing import Dict, Iterable, List, Tuple

NAME_WIDTH = 72


def find_pb(path: str) -> str:
    """The newest *.xplane.pb under `path` (or `path` itself)."""
    if os.path.isfile(path):
        return path
    hits = sorted(
        glob.glob(os.path.join(path, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not hits:
        raise FileNotFoundError(f"no *.xplane.pb under {path}")
    return hits[-1]


def load(path: str):
    import jax

    return jax.profiler.ProfileData.from_file(path)


def device_planes(pd) -> list:
    return [p for p in pd.planes if p.name.startswith("/device:")]


def _spans(lines) -> List[Tuple[float, float]]:
    return [
        (ev.start_ns, ev.start_ns + ev.duration_ns)
        for line in lines
        for ev in line.events
    ]


def union_ns(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def plane_busy_ns(plane) -> float:
    """Union of every event interval on the plane, across all its lines."""
    return union_ns(_spans(plane.lines))


def plane_window_ns(plane) -> float:
    """First event start to last event end on the plane."""
    spans = _spans(plane.lines)
    if not spans:
        return 0.0
    return max(e for _, e in spans) - min(s for s, _ in spans)


def device_busy_ms(pd) -> float:
    """Busy time summed over device planes (ms)."""
    return sum(plane_busy_ns(p) for p in device_planes(pd)) / 1e6


def host_span_ns(pd, name: str) -> Tuple[float, float]:
    """(start, end) of the first host event called `name`: the span of a
    jax.profiler.TraceAnnotation, on the same clock as the device events."""
    for plane in pd.planes:
        if plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.name == name:
                    return ev.start_ns, ev.start_ns + ev.duration_ns
    raise KeyError(f"no host event named {name!r} in the trace")


def device_busy_in_ms(pd, t0: float, t1: float) -> float:
    """Busy time of the device planes inside the window [t0, t1] (ms)."""
    return sum(
        union_ns(
            (max(s, t0), min(e, t1))
            for s, e in _spans(p.lines) if e > t0 and s < t1
        )
        for p in device_planes(pd)
    ) / 1e6


def op_table(plane) -> Dict[str, Tuple[float, int]]:
    """{op name: (total device ns, event count)} on a plane."""
    tot: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    for line in plane.lines:
        for ev in line.events:
            tot[ev.name] += ev.duration_ns
            cnt[ev.name] += 1
    return {k: (tot[k], cnt[k]) for k in tot}


def summarize(pd, top: int = 30, by_line: bool = False) -> None:
    planes = device_planes(pd)
    if not planes:
        # CPU-backend traces carry no device plane; summarize the host
        # planes so `pano.sh perf` still yields a per-op table.
        planes = [p for p in pd.planes if _spans(p.lines)]
        if planes:
            print("(no device plane in trace; summarizing host planes)")
    for plane in planes:
        print(
            f"\n=== plane: {plane.name}  "
            f"busy={plane_busy_ns(plane) / 1e6:.3f} ms  "
            f"window={plane_window_ns(plane) / 1e6:.3f} ms ==="
        )
        for line in plane.lines:
            spans = _spans([line])
            print(
                f"-- line: {line.name}  events={len(spans)}  "
                f"busy={union_ns(spans) / 1e6:.3f} ms"
            )
        if by_line:
            continue
        rows = sorted(
            op_table(plane).items(), key=lambda kv: -kv[1][0]
        )[:top]
        # Library kernels carry whole C++ signatures as names.
        width = min(max((len(n) for n, _ in rows), default=4), NAME_WIDTH)
        for name, (ns, n) in rows:
            print(f"  {name[:width]:<{width}}  {ns / 1e6:9.3f} ms  x{n}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="trace dir or .xplane.pb file")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--by-line", action="store_true",
                    help="only per-line busy totals")
    args = ap.parse_args()
    pb = find_pb(args.path)
    print(f"reading {pb}")
    summarize(load(pb), args.top, args.by_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
