"""The ordered scan (``csrc/ordered_scan.cu``): float64 prefix sums added in order.

The port's own kernel; it replaces no TPU kernel.  The reference's lockstep
solvers (``repro/core/lockstep.py``, ``lockstep_tiered.py``) are
bit-identical to its event engine only because numpy adds each per-port busy
chain and each queued-time sum strictly left to right (``np.cumsum`` is a
sequential ``np.add.accumulate``).  ``torch.cumsum`` and ``torch.sum`` on the
card add in a parallel order, and one ulp in an arrival time can move a
flag's set cycle by one.  The port's solvers therefore lay every such sum out
as the columns of a ``[L, R]`` matrix and scan it here, one lane a column, in
order.

Two entries: :func:`ordered_scan` returns the whole scan ``[L, R]``;
:func:`ordered_total` only its last row ``[R]``
(``np.add.accumulate(x, 0)[-1]``), which the kernel then reads once and never
writes whole.  Each dispatches on the tensor's device: the kernel for a CUDA
tensor, the plain version (:func:`ordered_scan_ref`, :func:`ordered_total_ref`,
loops over the leading dimension vectorised across the columns) for a CPU
tensor.  The kernel's launch plan is :func:`ordered_scan_plan`.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Tuple

import torch

from . import build

__all__ = ["STRIP", "TINY_ROWS", "ordered_scan", "ordered_scan_cuda", "ordered_scan_plan",
           "ordered_scan_ref", "ordered_total", "ordered_total_cuda", "ordered_total_ref"]

STRIP = 16  # columns a CTA of the wide plan (kStrip in csrc/ordered_scan.cu)
TINY_ROWS = 16  # the tiny plan's most rows (kTinyRows)
_PLAN_CODE = {"tiny": 0, "narrow": 1, "wide": 2}


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


def ordered_total_ref(x: torch.Tensor) -> torch.Tensor:
    """The plain version of the last row: the accumulator starts as a copy of
    ``x[0]`` and adds each later row in turn, as
    ``np.add.accumulate(x, axis=0)[-1]``."""
    _check("ordered_total_ref", x)
    acc = x[0].clone()
    for j in range(1, x.shape[0]):
        acc.add_(x[j])
    return acc


def ordered_scan_plan(L: int, R: int, aligned: bool) -> Tuple[str, int]:
    """The kernel's launch for an ``[L, R]`` matrix whose data is
    (``aligned``) or is not 16-byte aligned: ``(plan, vec)``.  ``"tiny"`` for
    ``L <= TINY_ROWS``: a thread a column reads its rows from x directly;
    ``"wide"`` for ``R >= STRIP``: a CTA a strip of :data:`STRIP` columns;
    else ``"narrow"``: one CTA over whole rows.  ``vec``, the bytes a copy
    into shared memory, is 16 where every copy's start is 16-byte aligned (a
    wide row segment starts at an even offset only for an even ``R``), else
    8 (and 8 for the tiny plan, which loads 8 bytes at a time)."""
    if L < 1 or R < 1:
        raise ValueError(f"ordered_scan_plan takes L, R >= 1, got {L}, {R}")
    if L <= TINY_ROWS:
        return "tiny", 8
    wide = R >= STRIP
    return ("wide" if wide else "narrow"), (16 if aligned and (R % 2 == 0 or not wide) else 8)


@functools.cache
def _launch_fn():
    fn = build.load("ordered_scan").ordered_scan_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, x: torch.Tensor, total: bool) -> torch.Tensor:
    _check(f"{entry}_cuda", x)
    if not x.is_cuda:
        raise ValueError(f"{entry}_cuda launches on a CUDA tensor, got {x.device}")
    x = x.contiguous()
    L, R = x.shape
    out = torch.empty(R if total else (L, R), dtype=x.dtype, device=x.device)
    plan, vec = ordered_scan_plan(L, R, x.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _launch_fn()(x.data_ptr(), out.data_ptr(), L, R, _PLAN_CODE[plan], vec, total,
                          stream)
    if status != 0:
        raise RuntimeError(f"ordered_scan kernel launch ({entry}, [{L}, {R}]) failed with "
                           f"CUDA error {status}")
    ordered_scan_cuda.launches += 1
    ordered_scan_cuda.by_shape[entry, L, R] += 1
    return out


def ordered_scan_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on ``x`` (a float64 ``[L, R]`` CUDA tensor) and
    return the scan along dim 0.  Raises on anything else, and on a launch the
    runtime refuses.  Each launch adds one to ``ordered_scan_cuda.launches``
    and to ``ordered_scan_cuda.by_shape["ordered_scan", L, R]``."""
    return _launch("ordered_scan", x, total=False)


ordered_scan_cuda.launches = 0
# launches of both entries by (entry, L, R), beside the count
ordered_scan_cuda.by_shape = collections.Counter()


def ordered_total_cuda(x: torch.Tensor) -> torch.Tensor:
    """The kernel with the totals flag: the scan's last row ``[R]``, the only
    row it writes.  Its launches count in ``ordered_scan_cuda.launches`` and
    in ``ordered_scan_cuda.by_shape["ordered_total", L, R]``."""
    return _launch("ordered_total", x, total=True)


def ordered_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float64 scan along dim 0 of ``x [L, R]``, each column added
    in order: the kernel on the card, the plain version on the CPU."""
    if x.is_cuda:
        return ordered_scan_cuda(x)
    return ordered_scan_ref(x)


def ordered_total(x: torch.Tensor) -> torch.Tensor:
    """``ordered_scan(x)[-1]``, the last row alone: the kernel on the card,
    the plain version on the CPU."""
    if x.is_cuda:
        return ordered_total_cuda(x)
    return ordered_total_ref(x)
