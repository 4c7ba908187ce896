"""Stage timing with the reference's machine-readable stdout contract.

Every pipeline stage in the reference prints `"<Stage Name>: x.xxx ms"` to
stdout (src/serial/main.cpp:43-58 Timer class; printed at :182-183, :241-242,
:301-302, :388-389, :411-412, :448-449). The benchmark layer greps those exact
strings (benchmark_panorama.py:33-35, benchmark_serial_parallel.py:27,51-55),
so the format is an API, not logging. We keep it byte-compatible.

Device dispatch is asynchronous, so callers block on a stage's outputs with
jax.block_until_ready before they stop its clock.
"""

from __future__ import annotations

import time


class Timer:
    """Wall-clock ms timer (reference Timer, src/serial/main.cpp:43-58)."""

    def __init__(self):
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        return (time.perf_counter() - self._start) * 1e3

    def reset(self) -> None:
        self._start = time.perf_counter()


# Machine-readable stage record, populated by every print_stage call; the
# CLI's --json option dumps it (SURVEY §5 observability plan). Reset per run.
STAGE_RECORDS: list = []


def reset_stage_records() -> None:
    STAGE_RECORDS.clear()


def print_stage(name: str, ms: float) -> None:
    # Exact reference format: fixed, 3 decimals (src/serial/main.cpp:183).
    STAGE_RECORDS.append({"stage": name, "ms": round(ms, 3)})
    print(f"{name}: {ms:.3f} ms", flush=True)
