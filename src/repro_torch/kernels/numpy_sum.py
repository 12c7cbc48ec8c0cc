"""numpy's sum (``csrc/numpy_sum.cu``): float64 segment sums in numpy's order.

The port's own kernel; it replaces no TPU kernel.  The reference's tiered
lockstep solver adds ``float(q.sum())`` of every priced stage and chunk into
the fabric's queued totals, and numpy's sum is pairwise: the vector's blocks
of :data:`BLOCK` elements are added left to right into 0.0, each block summed
by numpy's ``pairwise_sum`` (below 8 elements left to right; up to
:data:`LEAF` in eight strided accumulators combined as
``((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))`` and then the
remainder; above that split at half the length rounded down to a multiple of
8).  A left-to-right sum or torch's own tree differs from it in the last
bits.

:func:`numpy_sum` takes the segments ``x[offs[s]:offs[s + 1]]`` and returns
their sums, ``[S]``: the kernel for a CUDA tensor, the plain version
(:func:`numpy_sum_ref`) for a CPU tensor.  The plain version evaluates the
same tree vectorised: every leaf of every segment at once (a row of an
``[leaves, LEAF]`` matrix), then the inner nodes height by height, then the
blocks of each segment in order.  The kernel takes one block a CTA
(:func:`numpy_sum_plan`); a segment of several blocks is joined by tickets in
a workspace kept per stream (:func:`numpy_sum_workspace`).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from . import build

__all__ = ["BLOCK", "LEAF", "NumpySumPlan", "numpy_sum", "numpy_sum_cuda", "numpy_sum_plan",
           "numpy_sum_ref", "numpy_sum_workspace"]

BLOCK = 8192  # numpy's ufunc buffer, in elements
LEAF = 128    # numpy's PW_BLOCKSIZE
MAX_CTAS = 2**31 - 1  # a grid's x extent
MIN_WINDOWS = 1 << 12  # the workspace's least size, in windows (32M elements)


def _check(name: str, x: torch.Tensor, offs: torch.Tensor) -> None:
    if x.dtype != torch.float64 or x.dim() != 1 or offs.dtype != torch.int64 \
            or offs.dim() != 1 or offs.numel() < 1:
        raise ValueError(f"{name} takes a float64 [T] tensor and int64 offsets [S + 1], "
                         f"got {x.dtype} {tuple(x.shape)} and {offs.dtype} "
                         f"{tuple(offs.shape)}")


@functools.lru_cache(maxsize=None)
def _tree(n: int) -> Tuple[np.ndarray, ...]:
    """numpy's pairwise tree over ``n <= BLOCK`` elements, with local node
    ids (the leaves ``0..nl - 1`` in order, then the inner nodes as they are
    made): the leaves' starts and lengths, the inner nodes' left child, right
    child and height (a leaf's is 0), and the root's id."""
    leaves: List[Tuple[int, int]] = []
    inner: List[Tuple[tuple, tuple, int]] = []

    def walk(lo: int, m: int) -> tuple:  # ("leaf" | "inner", index, height)
        if m <= LEAF:
            leaves.append((lo, m))
            return ("leaf", len(leaves) - 1, 0)
        m2 = m // 2
        m2 -= m2 % 8
        a, b = walk(lo, m2), walk(lo + m2, m - m2)
        inner.append((a, b, 1 + max(a[2], b[2])))
        return ("inner", len(inner) - 1, inner[-1][2])

    root = walk(0, n)
    nl = len(leaves)

    def local(node: tuple) -> int:
        return node[1] if node[0] == "leaf" else nl + node[1]

    start, length = (np.array(v, np.int64).reshape(-1) for v in zip(*leaves))
    left = np.array([local(a) for a, _, _ in inner], np.int64)
    right = np.array([local(b) for _, b, _ in inner], np.int64)
    height = np.array([h for _, _, h in inner], np.int64)
    return start, length, left, right, height, local(root)


def _leaf_sums(x: torch.Tensor, start: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """numpy's leaf sum of ``x[start:start + length]`` for every leaf at once
    (``length <= LEAF``)."""
    cols = torch.arange(LEAF, device=x.device)
    idx = start[:, None] + cols
    inside = cols < length[:, None]
    X = torch.where(inside, x[idx.clamp(max=max(x.numel() - 1, 0))], 0.0)
    # below 8 elements: 0.0 and then each element in order
    short = torch.zeros(len(start), dtype=x.dtype, device=x.device)
    for i in range(7):
        short = torch.where(i < length, short + X[:, i], short)
    # 8 to LEAF: eight strided accumulators, combined, then the remainder
    steps = length // 8
    r = X[:, :8]
    for s in range(1, LEAF // 8):
        r = torch.where((s < steps)[:, None], r + X[:, 8 * s:8 * s + 8], r)
    res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
    for i in range(7):
        pos = 8 * steps + i
        res = torch.where(pos < length,
                          res + X.gather(1, pos.clamp(max=LEAF - 1)[:, None])[:, 0], res)
    return torch.where(length < 8, short, res)


def numpy_sum_ref(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The plain version: numpy's sum of each segment, ``[S]``."""
    _check("numpy_sum_ref", x, offs)
    offs_h = offs.tolist()
    S = len(offs_h) - 1
    blocks = [(s, b, _tree(min(BLOCK, offs_h[s + 1] - b)))
              for s in range(S) for b in range(offs_h[s], offs_h[s + 1], BLOCK)]
    n_leaves = sum(len(t[0]) for _, _, t in blocks)
    # global node ids: every block's leaves first, in order, then every
    # block's inner nodes
    starts, lengths, lefts, rights, heights, roots = [], [], [], [], [], []
    leaf_off = inner_off = 0
    for s, b, (st, ln, lt, rt, ht, root) in blocks:
        nl = len(st)

        def glob(v, nl=nl, leaf_off=leaf_off, inner_off=inner_off):
            return np.where(v < nl, v + leaf_off, n_leaves + inner_off + v - nl)

        starts.append(st + b)
        lengths.append(ln)
        lefts.append(glob(lt))
        rights.append(glob(rt))
        heights.append(ht)
        roots.append((s, int(glob(np.int64(root)))))
        leaf_off += nl
        inner_off += len(lt)
    dev = x.device
    vals = torch.empty(n_leaves + inner_off, dtype=x.dtype, device=dev)
    if n_leaves:
        vals[:n_leaves] = _leaf_sums(x, torch.as_tensor(np.concatenate(starts), device=dev),
                                     torch.as_tensor(np.concatenate(lengths), device=dev))
    if inner_off:
        L, R, H = (torch.as_tensor(np.concatenate(v), device=dev)
                   for v in (lefts, rights, heights))
        ids = torch.arange(n_leaves, n_leaves + inner_off, device=dev)
        for h in range(1, int(H.max()) + 1):
            at = H == h
            vals[ids[at]] = vals[L[at]] + vals[R[at]]
    # the blocks of each segment, left to right into 0.0
    per_seg = [[] for _ in range(S)]
    for s, r in roots:
        per_seg[s].append(r)
    width = max((len(r) for r in per_seg), default=0)
    rid = torch.as_tensor(np.array([r + [-1] * (width - len(r)) for r in per_seg],
                                   np.int64).reshape(S, width), device=dev)
    out = torch.zeros(S, dtype=x.dtype, device=dev)
    for j in range(width):
        out = torch.where(rid[:, j] >= 0, out + vals[rid[:, j].clamp(min=0)], out)
    return out


@dataclass(frozen=True)
class NumpySumPlan:
    """One launch: a CTA for block 0 of each segment, then one for each later
    8,192-element window of x (the block of a longer segment starting in it,
    if any), ``ctas`` in all; ``windows`` slots of workspace and tickets (one
    a window of x)."""

    ctas: int
    windows: int


def numpy_sum_plan(S: int, T: int) -> NumpySumPlan:
    """The launch for ``S`` segments of a ``T``-element vector, from what the
    host knows (no segment length); pure, so it runs (and is tested) on the
    CPU.  A block of a segment starts at the segment's start or 8,192
    elements after a block start, so at most one later block starts in each
    window ``[BLOCK c, BLOCK (c + 1))``, ``c >= 1``: the grid is ``S`` plus
    those windows."""
    if S < 0 or T < 0:
        raise ValueError(f"numpy_sum_plan takes S >= 0 and T >= 0, got S={S}, T={T}")
    later = (T - 1) // BLOCK if T else 0
    if S + later > MAX_CTAS:
        raise ValueError(f"numpy_sum: {S} segments of {T} elements need {S + later} CTAs, "
                         f"more than a grid's {MAX_CTAS}")
    return NumpySumPlan(ctas=S + later, windows=later + 1)


_WORKSPACES: dict = {}


def numpy_sum_workspace(device: torch.device, stream: int,
                        windows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ws, tickets)`` of the launches on one CUDA stream: two float64 block
    sums and one int32 ticket a window, at least ``windows`` (and
    ``MIN_WINDOWS``; grown to a power of two).  The tickets are zeroed once,
    when made, and every launch leaves them at 0.  Kept a stream, so that
    launches on two streams never share them."""
    key = (device, stream)
    ws, tickets = _WORKSPACES.get(key, (None, None))
    if tickets is None or tickets.numel() < windows:
        size = max(MIN_WINDOWS, 1 << max(windows - 1, 0).bit_length())
        ws = torch.empty(2 * size, dtype=torch.float64, device=device)
        tickets = torch.zeros(size, dtype=torch.int32, device=device)
        _WORKSPACES[key] = (ws, tickets)
    return ws, tickets


@functools.cache
def _launch_fn():
    fn = build.load("numpy_sum").numpy_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def numpy_sum_cuda(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors and return the ``[S]`` sums.  Raises
    on anything else, and on a launch the runtime refuses.  Each launch adds
    one to ``numpy_sum_cuda.launches``."""
    _check("numpy_sum_cuda", x, offs)
    if not (x.is_cuda and offs.is_cuda):
        raise ValueError(f"numpy_sum_cuda launches on CUDA tensors, got {x.device}")
    x, offs = x.contiguous(), offs.contiguous()
    S = offs.numel() - 1
    out = torch.empty(S, dtype=x.dtype, device=x.device)
    if S == 0:
        return out
    plan = numpy_sum_plan(S, x.numel())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws, tickets = numpy_sum_workspace(x.device, stream, plan.windows)
    status = _launch_fn()(x.data_ptr(), offs.data_ptr(), out.data_ptr(), ws.data_ptr(),
                          tickets.data_ptr(), S, plan.ctas, stream)
    if status != 0:
        raise RuntimeError(f"numpy_sum kernel launch failed with CUDA error {status}")
    numpy_sum_cuda.launches += 1
    return out


numpy_sum_cuda.launches = 0


def numpy_sum(x: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """numpy's sum of each segment ``x[offs[s]:offs[s + 1]]``: the kernel on
    the card, the plain version on the CPU."""
    if x.is_cuda:
        return numpy_sum_cuda(x, offs)
    return numpy_sum_ref(x, offs)
