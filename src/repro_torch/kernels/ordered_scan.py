"""The ordered scan (``csrc/ordered_scan.cu``): float64 prefix sums added in order.

The port's own kernel; it replaces no TPU kernel.  The reference's flat
lockstep solver (``repro/core/lockstep.py``) is bit-identical to its event
engine only because numpy adds each per-port busy chain and each queued-time
sum strictly left to right (``np.cumsum`` is a sequential
``np.add.accumulate``).  ``torch.cumsum`` and ``torch.sum`` on the card add in
a parallel order, and one ulp in an arrival time can move a flag's set cycle
by one.  The port's solver therefore lays every such sum out as the columns
of a ``[L, R]`` matrix and scans it here: one thread a column, in order.

:func:`ordered_scan` dispatches on the tensor's device: the kernel for a CUDA
tensor, the plain version (:func:`ordered_scan_ref`, a loop over the leading
dimension vectorised across the columns) for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["ordered_scan", "ordered_scan_cuda", "ordered_scan_ref"]


def _check(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float64 or x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name} takes a float64 [L, R] tensor with L, R >= 1, "
                         f"got {x.dtype} {tuple(x.shape)}")


def ordered_scan_ref(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``out[0] = x[0]``, ``out[j] = out[j - 1] + x[j]``,
    one float64 add a step, as ``np.add.accumulate(x, axis=0)``."""
    _check("ordered_scan_ref", x)
    out = torch.empty_like(x)
    out[0] = x[0]
    for j in range(1, x.shape[0]):
        torch.add(out[j - 1], x[j], out=out[j])
    return out


@functools.cache
def _launch_fn():
    fn = build.load("ordered_scan").ordered_scan_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ordered_scan_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on ``x`` (a float64 ``[L, R]`` CUDA tensor) and
    return the scan along dim 0.  Raises on anything else, and on a launch the
    runtime refuses.  Each launch adds one to ``ordered_scan_cuda.launches``."""
    _check("ordered_scan_cuda", x)
    if not x.is_cuda:
        raise ValueError(f"ordered_scan_cuda launches on a CUDA tensor, got {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _launch_fn()(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], stream)
    if status != 0:
        raise RuntimeError(f"ordered_scan kernel launch failed with CUDA error {status}")
    ordered_scan_cuda.launches += 1
    return out


ordered_scan_cuda.launches = 0


def ordered_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float64 scan along dim 0 of ``x [L, R]``, each column added
    in order: the kernel on the card, the plain version on the CPU."""
    if x.is_cuda:
        return ordered_scan_cuda(x)
    return ordered_scan_ref(x)
