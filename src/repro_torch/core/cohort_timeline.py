"""Closed-form replay of a device lane's phase program, on a torch device.

Port of ``repro/core/cohort_timeline.py::replay_lane_jax`` (the JAX scan
over ``replay_lane_numpy``'s closed form).  A lane is a program of steps,
each either timed (advance the cursor by a duration) or a spin wait on one
flag that becomes visible at cycle V: a cohort whose cursor is t polls every
``poll`` cycles, so it reads the flag ``nticks + 1`` times with
``nticks = max(ceil((V - t) / poll), 0)`` and leaves the wait at
``t + nticks * poll + check``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["replay_lane", "spin_wait"]


def spin_wait(t: torch.Tensor, visible: int, poll: int, check: int):
    """One spin wait from cursors ``t`` on a flag visible at ``visible``:
    returns ``(flag reads per cohort member, cursors after the wait)``."""
    nticks = torch.clamp((visible - t + poll - 1) // poll, min=0)
    return nticks + 1, t + nticks * poll + check


def replay_lane(dispatch, is_wait, val, *, poll: int, check: int, device=None):
    """Replay a whole lane closed-form for every cohort at once.

    ``dispatch``: per-cohort dispatch cycles; ``is_wait``, ``val``: the
    per-step arrays of ``lane_step_arrays`` (a wait step's value is the flag's
    visibility cycle, a timed step's its duration).  Returns
    ``(flag_reads_per_cohort_member, end_cycle_per_cohort)`` as int64 tensors
    on ``device`` (the CUDA device unless the caller passes ``"cpu"``).

    The loop runs over steps on the host and each step is vectorised over
    cohorts.  The arithmetic is int64 throughout, like the reference's
    ground truth ``replay_lane_numpy``; the JAX version works in int32
    (jax's default), which this port does not copy.
    """
    dev = resolve_device(device)
    t = torch.as_tensor(np.asarray(dispatch, np.int64), device=dev)
    reads = torch.zeros_like(t)
    for w, v in zip(np.asarray(is_wait, bool).tolist(), np.asarray(val, np.int64).tolist(),
                    strict=True):
        if w:
            step_reads, t = spin_wait(t, v, poll, check)
            reads += step_reads
        else:
            t = t + v
    return reads, t
