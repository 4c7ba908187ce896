"""The one place that picks the devices the accelerator paths run on.

The `gpu` CLI implementation and the sharded paths run on the GPUs JAX
finds, and fail with a message naming the missing GPU when there are none:
nothing falls back to the CPU. The `serial` implementation is the explicit
CPU oracle and asks for `jax.devices("cpu")` itself.
"""

from __future__ import annotations

from typing import List

import jax


class NoGPUError(RuntimeError):
    """Raised when an accelerator path is asked for and JAX sees no GPU."""


def accelerators() -> List[jax.Device]:
    """Every GPU JAX can see, in device order; NoGPUError if none."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:  # no GPU backend in this process at all
        gpus = []
    if not gpus:
        raise NoGPUError(
            "no GPU found: JAX reports no 'gpu' devices (backend "
            f"{jax.default_backend()!r}). The 'gpu' and 'sharded' "
            "implementations need a CUDA GPU; use 'serial' for the CPU "
            "oracle."
        )
    return gpus


def accelerator() -> jax.Device:
    """The GPU single-device paths run on (the first one)."""
    return accelerators()[0]
