"""Owner-ordered GEMV partial tiles: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/gemv_tiles.py`` (the fused GEMV+AllReduce's compute
side, paper Fig. 3).  The values are ``gemv``'s; the schedule differs: the
``M // bm`` row tiles are issued in :func:`remote_first_order` (the tiles of
the ring successor ``my_dev + 1`` first, the device's own tiles last), and
the second output ``owner_served[c]`` is the owner of the c-th issued tile.
The kernel (``csrc/gemv_tiles.cu``) is persistent: its blocks claim work
items (a group of up to ``group`` consecutive tiles of one owner, times a K
slice of :func:`~repro_torch.kernels.gemv.gemv_plan`) from a global counter in
issue order, so tiles really start in that order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .gemv import GemvPlan, check_operands, gemv_plan, gemv_ref, sm_count

__all__ = ["gemv_tiles_cuda", "gemv_tiles_ref", "remote_first_order", "tile_plan", "GROUP"]

_MAX_BM = 64  # largest tile the kernel takes
GROUP = 2     # tiles an item (1, 2 and 4 measured: PERF.md)


def remote_first_order(n_dev: int, my_dev: int, tiles_per_dev: int) -> list[int]:
    """Tile visit order: successor owner's tiles first, own tiles last.

    The port's own copy of ``repro/kernels/gemv_tiles.py:26-33``, as a list.
    """
    order = []
    for step in range(1, n_dev + 1):
        owner = (my_dev + step) % n_dev
        for i in range(tiles_per_dev):
            order.append(owner * tiles_per_dev + i)
    return order


def tile_plan(M: int, n_dev: int, my_dev: int, bm: int) -> tuple[int, int]:
    """``(bm, tiles_per_dev)`` as the reference fixes them: ``bm = min(bm, M // n_dev)``
    and ``M % (n_dev * bm) == 0``, which ``owner_served`` depends on."""
    if not 0 <= my_dev < n_dev:
        raise ValueError(f"gemv_tiles needs 0 <= my_dev < n_dev, got {my_dev}, {n_dev}")
    bm = min(bm, M // n_dev)
    if bm < 1 or M % (n_dev * bm):
        raise ValueError(f"gemv_tiles needs M % (n_dev * bm) == 0, got M = {M}, "
                         f"n_dev = {n_dev}, bm = {bm}")
    return bm, M // n_dev // bm


def gemv_tiles_ref(a: torch.Tensor, x: torch.Tensor, n_dev: int, my_dev: int, bm: int = 64):
    """``(gemv_ref(a, x), owner_served)``: the plain version of both outputs.

    The reference's ``ref.gemv_tiles_ref`` returns the values only; here the
    schedule is built from :func:`remote_first_order` as well.
    """
    bm, tiles_per_dev = tile_plan(a.shape[0], n_dev, my_dev, bm)
    order = torch.tensor(remote_first_order(n_dev, my_dev, tiles_per_dev), dtype=torch.int32,
                         device=a.device)
    return gemv_ref(a, x), order // tiles_per_dev


@functools.cache
def _order(n_dev: int, my_dev: int, tiles_per_dev: int, device: torch.device) -> torch.Tensor:
    """The issue order as a device int32 tensor, built once per arguments."""
    return torch.tensor(remote_first_order(n_dev, my_dev, tiles_per_dev), dtype=torch.int32,
                        device=device)


@functools.cache
def _lib():
    lib = build.load("gemv_tiles")
    lib.gemv_tiles_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.gemv_tiles_launch.restype = ctypes.c_int
    lib.gemv_tiles_blocks_per_sm.argtypes = [ctypes.c_int] * 5
    lib.gemv_tiles_blocks_per_sm.restype = ctypes.c_int
    return lib


def blocks_per_sm(plan: GemvPlan, dtype: torch.dtype, N: int, col_major: int) -> int:
    """Blocks of ``gemv_tiles_cuda``'s kernel that one SM holds under ``plan``."""
    n = _lib().gemv_tiles_blocks_per_sm(N, col_major, build.DTYPE_CODE[dtype], plan.rows,
                                        plan.slice_k)
    if n <= 0:
        raise RuntimeError(f"gemv_tiles occupancy query failed with CUDA error {-n}")
    return n


def gemv_tiles_cuda(a: torch.Tensor, x: torch.Tensor, *, n_dev: int, my_dev: int,
                    bm: int = 64, plan: GemvPlan | None = None):
    """Launch the kernel on CUDA tensors; return ``(y [M, N], owner_served i32[M // bm])``.

    Takes what ``gemv``'s :func:`check_operands` allows, with the reference's
    tile rule (:func:`tile_plan`), ``bm <= 64`` and, for A = w.T, ``bm`` a
    multiple of 16 bytes.  Raises on anything else, and on a launch the
    runtime refuses.  ``plan`` defaults to :func:`gemv_plan` with ``GROUP``
    tiles an item on this card.  Each launch adds one to
    ``gemv_tiles_cuda.launches``.
    """
    M, K = a.shape
    bm, tiles_per_dev = tile_plan(M, n_dev, my_dev, bm)
    col_major, lda = check_operands("gemv_tiles_cuda", a, x)
    N = x.shape[1]
    vec = 16 // a.element_size()
    if bm > _MAX_BM or (col_major and bm % vec):
        raise ValueError(f"gemv_tiles_cuda takes bm <= {_MAX_BM} rows"
                         f"{f', a multiple of {vec} for A = w.T' if col_major else ''}; "
                         f"got bm = {bm}")
    if plan is None:
        plan = gemv_plan(M, K, N, a.element_size(), bm, sm_count(a.device), group=GROUP,
                         tiles_per_dev=tiles_per_dev)
    groups = M // bm // tiles_per_dev * -(-tiles_per_dev // plan.group)
    if plan.rows != plan.group * bm or plan.boxes != groups:
        raise ValueError(f"gemv_tiles_cuda needs a plan of {groups} groups of {plan.group} x "
                         f"{bm} rows, got {plan}")
    order = _order(n_dev, my_dev, tiles_per_dev, a.device)
    y = torch.empty(M, N, dtype=a.dtype, device=a.device)
    owner_served = torch.empty(M // bm, dtype=torch.int32, device=a.device)
    # the partials and the counters, which the launch zeroes
    ws = torch.empty(plan.workspace_bytes(M, N, 1 + plan.boxes), dtype=torch.uint8,
                     device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    status = _lib().gemv_tiles_launch(
        a.data_ptr(), x.data_ptr(), y.data_ptr(), owner_served.data_ptr(), order.data_ptr(),
        ws.data_ptr(), M, K, N, lda, col_major, bm, tiles_per_dev, plan.group, plan.splits,
        plan.slice_k, build.DTYPE_CODE[a.dtype], stream)
    if status != 0:
        raise RuntimeError(f"gemv_tiles kernel launch failed with CUDA error {status}")
    gemv_tiles_cuda.launches += 1
    return y, owner_served


gemv_tiles_cuda.launches = 0
