"""The spin-wait closed form of the vector engine, on a torch device.

Port of ``repro/core/vector_engine.py::spin_reads_jax``: every workgroup
enters the GEMV+AllReduce's ``wait_flags`` phase at its own cycle and polls
the peers' flags one after another, in polling order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .cohort_timeline import spin_wait

__all__ = ["spin_reads"]


def spin_reads(wait_start, flag_T, poll: int, check: int, device=None):
    """Flag reads and the cursor after the last flag, per workgroup, in SPIN mode.

    ``wait_start``: per-workgroup wait-phase entry cycles; ``flag_T``: the
    flags' visibility cycles in polling order.  A flag already visible costs
    one read and ``check`` cycles; otherwise ``ceil((T - c) / poll)`` more
    polls.  Returns ``(reads_per_wg, cursor_after)`` as int64 tensors on
    ``device`` (the CUDA device unless the caller passes ``"cpu"``).  The
    reference's JAX scan carries the cursor in float32; this port keeps
    integer cycles in int64, as the numpy closed form does.
    """
    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(wait_start, np.int64), device=dev)
    reads = torch.zeros_like(c)
    for T in np.asarray(flag_T, np.int64).tolist():
        step_reads, c = spin_wait(c, T, poll, check)
        reads += step_reads
    return reads, c
