"""The launch floor: an empty CUDA kernel's wrapper (``csrc/empty.cu``).

It computes nothing and replaces no TPU kernel.  ``chip_smoke.py`` times it
in the same profile as ``rmsnorm`` and ``F.rms_norm``, so a launch-bound
kernel's device time is read beside the least any launch of this build
takes on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["empty_cuda"]


@functools.cache
def _launch_fn():
    fn = build.load("empty").empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def empty_cuda(device: torch.device) -> None:
    """Launch the empty kernel on ``device``'s current stream (a CUDA device).

    Raises on a launch the runtime refuses.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"empty_cuda launches on a CUDA device, got {device}")
    status = _launch_fn()(torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"empty kernel launch failed with CUDA error {status}")
