"""Tiled GEMV: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/gemv.py`` (the fused GEMV+AllReduce's compute hot
loop).  ``y[M, N] = A[M, K] @ x[K, N]`` with float32 accumulation, in A's
dtype.  The kernel (``csrc/gemv.cu``) runs one block per work item (a box of
rows and a slice of K, chosen by :func:`gemv_plan`), streams A through a
shared-memory ring, and sums the slices' float32 partials in slice order in
the same launch; :func:`gemv_ref` is the same function in plain PyTorch, used
on the CPU and held against the kernel on the card.

The kernel reads A through its strides in two layouts: row-major
(``stride_k == 1``) and the transpose of a row-major ``w[K, M]``
(``stride_m == 1``), which is how the collectives pass their weight shard
without copying it.  :func:`check_operands` is shared with ``gemv_tiles``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import build

__all__ = ["gemv_cuda", "gemv_ref", "gemv_plan", "GemvPlan", "check_operands", "MAX_N",
           "TILE_ROWS"]

MAX_N = 8        # kMaxN in csrc/gemv_tile.cuh: columns of x the kernels take
STAGES = 4       # kStages: the ring's stages
STAGE_BYTES = 8192  # kStageBytes: bytes of A a stage
MAX_ROWS = 256   # kMaxRows: rows of the largest box
TILE_ROWS = 64   # gemv's box rows (64, 128 and 256 measured: PERF.md)
ITEMS_PER_SM = 2  # work items a plan aims at for each SM (1 to 8 measured: PERF.md)
X_SMEM_BYTES = 48 * 1024  # x's slice in shared memory, float32 [slice_k, 4 or 8]
MIN_SLICE_K = 32  # elements of K below which a slice is not worth a block


@dataclass(frozen=True)
class GemvPlan:
    """How a launch cuts the product into work items (boxes x K slices).

    ``rows``: rows of A a box covers (``group`` tiles of ``gemv_tiles``' bm);
    ``splits`` slices of ``slice_k`` elements of K (a multiple of 16 bytes;
    the last may be shorter) cover K exactly once; ``boxes`` boxes of rows.
    """

    rows: int
    splits: int
    slice_k: int
    boxes: int
    group: int = 1

    @property
    def items(self) -> int:
        return self.boxes * self.splits

    def workspace_bytes(self, M: int, N: int, counters: int) -> int:
        """float32 partials [splits, M, N] (when split) and ``counters`` int32."""
        return (4 * self.splits * M * N if self.splits > 1 else 0) + 4 * counters


@functools.lru_cache(maxsize=256)
def gemv_plan(M: int, K: int, N: int, itemsize: int, bm: int, sms: int, *, group: int = 1,
              tiles_per_dev: int | None = None, items_per_sm: int = ITEMS_PER_SM) -> GemvPlan:
    """Choose the K split of a launch; pure, so it runs (and is tested) on the CPU.

    Boxes: ``ceil(M / bm)`` of ``bm`` rows (``gemv``), or with ``tiles_per_dev``
    (``gemv_tiles``) the groups of up to ``group`` consecutive tiles of one
    owner, ``ceil(tiles_per_dev / group)`` an owner, of ``group * bm`` rows.
    Splits aim at ``items_per_sm * sms`` items; a slice keeps at least
    ``MIN_SLICE_K`` elements and at most what x's float32 slice may take of
    shared memory (``X_SMEM_BYTES``).
    """
    vec = 16 // itemsize
    if not (M >= 1 and K >= vec and K % vec == 0 and 1 <= N <= MAX_N and sms >= 1
            and group >= 1 and 1 <= bm and group * bm <= MAX_ROWS):
        raise ValueError(f"gemv_plan takes M >= 1, K a positive multiple of {vec}, "
                         f"1 <= N <= {MAX_N} and boxes of at most {MAX_ROWS} rows; got "
                         f"M={M}, K={K}, N={N}, bm={bm}, group={group}, sms={sms}")
    if tiles_per_dev is None:
        rows, boxes = bm, -(-M // bm)
    else:
        rows = group * bm
        boxes = M // bm // tiles_per_dev * -(-tiles_per_dev // group)
    max_k = X_SMEM_BYTES // ((4 if N <= 4 else 8) * 4) // vec * vec
    min_k = min(K, max(vec, MIN_SLICE_K))
    want = -(-items_per_sm * sms // boxes)
    splits = max(-(-K // max_k), min(want, K // min_k), 1)
    per_split = -(-K // splits)
    slice_k = -(-per_split // vec) * vec  # rounded up to whole 16-byte vectors
    return GemvPlan(rows=rows, splits=-(-K // slice_k), slice_k=slice_k, boxes=boxes,
                    group=group)


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def gemv_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x``: a [M, K], x [K, N] -> [M, N], in a's dtype.

    The sums are taken in float64 and rounded once.  A product of two float32
    (or bf16) elements is exact in float64, and a float64 sum of K of them is
    within about K * 2^-53 of the exact one, far inside a float32 ulp: so any
    order a BLAS, its blocking or the host's thread count gives the sums
    rounds to the same result (but for a sum that close to a rounding
    boundary), whatever A's layout.  A float32 sum's last bits would not: one
    CPU BLAS misses the float64 answer by 2e-4 at [256, 2048].
    """
    return (a.double() @ x.double()).to(a.dtype)


def check_operands(name: str, a: torch.Tensor, x: torch.Tensor) -> tuple[int, int]:
    """Refuse what the kernels do not take; return ``(col_major, lda)`` of A.

    The kernels take CUDA tensors (checked last, so that every other refusal
    shows on the CPU too) of one dtype (float32 or bfloat16), x [K, N]
    contiguous with 1 <= N <= 8, K a multiple of 16 bytes, and A either
    row-major or column-major (``A = w.T``) with 16-byte aligned rows or
    columns; in the column-major layout M is a multiple of 16 bytes too.
    """
    if a.dtype not in build.DTYPE_CODE or x.dtype != a.dtype:
        raise ValueError(f"{name} takes float32 or bfloat16 a with x of the same dtype, "
                         f"got {a.dtype} and {x.dtype}")
    if a.dim() != 2 or x.dim() != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"{name} needs a [M, K] and x [K, N], got {tuple(a.shape)} and "
                         f"{tuple(x.shape)}")
    M, K = a.shape
    N = x.shape[1]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"{name} takes 1 <= N <= {MAX_N} columns of x, got N = {N}")
    if a.stride(1) == 1 and (M == 1 or a.stride(0) >= K):
        col_major, lda = 0, (a.stride(0) if M > 1 else K)
    elif a.stride(0) == 1 and (K == 1 or a.stride(1) >= M):
        col_major, lda = 1, (a.stride(1) if K > 1 else M)
    else:
        raise ValueError(f"{name} takes a row-major A (stride_k == 1) or A = w.T "
                         f"(stride_m == 1), got strides {a.stride()}")
    vec = 16 // a.element_size()
    if K % vec or lda % vec or (col_major and M % vec):
        raise ValueError(f"{name} needs K, the leading stride{' and M' if col_major else ''} "
                         f"to be multiples of {vec} elements (16 bytes), got a "
                         f"{tuple(a.shape)} with strides {a.stride()}")
    if a.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned A")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous x")
    if max(M, K) >= 2 ** 31:
        raise ValueError(f"{name} takes M and K below 2**31")
    if not (a.device.type == "cuda" and x.device == a.device):
        raise ValueError(f"{name} needs CUDA tensors on one device, got a on {a.device} "
                         f"and x on {x.device}")
    return col_major, lda


@functools.cache
def _lib():
    lib = build.load("gemv")
    lib.gemv_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.gemv_launch.restype = ctypes.c_int
    lib.gemv_blocks_per_sm.argtypes = [ctypes.c_int] * 5
    lib.gemv_blocks_per_sm.restype = ctypes.c_int
    return lib


def blocks_per_sm(plan: GemvPlan, dtype: torch.dtype, N: int, col_major: int) -> int:
    """Blocks of ``gemv_cuda``'s kernel that one SM holds under ``plan``."""
    n = _lib().gemv_blocks_per_sm(N, col_major, build.DTYPE_CODE[dtype], plan.rows,
                                  plan.slice_k)
    if n <= 0:
        raise RuntimeError(f"gemv occupancy query failed with CUDA error {-n}")
    return n


def gemv_cuda(a: torch.Tensor, x: torch.Tensor, *, plan: GemvPlan | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors and return ``y[M, N]`` in a's dtype.

    Takes what :func:`check_operands` allows and raises on anything else, and
    on a launch the runtime refuses.  ``plan`` defaults to :func:`gemv_plan`
    with boxes of ``TILE_ROWS`` rows on this card.  The float32 partials and
    the arrival counters live in one workspace allocated per call.  Each
    launch adds one to ``gemv_cuda.launches``.
    """
    col_major, lda = check_operands("gemv_cuda", a, x)
    M, K = a.shape
    N = x.shape[1]
    if plan is None:
        plan = gemv_plan(M, K, N, a.element_size(), TILE_ROWS, sm_count(a.device))
    if plan.boxes != -(-M // plan.rows):
        raise ValueError(f"gemv_cuda needs a plan of {-(-M // plan.rows)} boxes of "
                         f"{plan.rows} rows, got {plan}")
    y = torch.empty(M, N, dtype=a.dtype, device=a.device)
    ws = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_bytes(M, N, plan.boxes), dtype=torch.uint8,
                         device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    status = _lib().gemv_launch(a.data_ptr(), x.data_ptr(), y.data_ptr(),
                                None if ws is None else ws.data_ptr(), M, K, N, lda, col_major,
                                build.DTYPE_CODE[a.dtype], plan.rows, plan.splits, plan.slice_k,
                                stream)
    if status != 0:
        raise RuntimeError(f"gemv kernel launch failed with CUDA error {status}")
    gemv_cuda.launches += 1
    return y


gemv_cuda.launches = 0
