"""Tiled GEMV: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/gemv.py`` (the fused GEMV+AllReduce's compute hot
loop).  ``y[M, N] = A[M, K] @ x[K, N]`` with float32 accumulation, in A's
dtype.  The kernel (``csrc/gemv.cu``) runs one block per 32-row tile with the
K loop inside the block; :func:`gemv_ref` is the same function in plain
PyTorch, used on the CPU and held against the kernel on the card.

The kernel reads A through its strides in two layouts: row-major
(``stride_k == 1``) and the transpose of a row-major ``w[K, M]``
(``stride_m == 1``), which is how the collectives pass their weight shard
without copying it.  :func:`check_operands` is shared with ``gemv_tiles``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["gemv_cuda", "gemv_ref", "check_operands", "MAX_N"]

MAX_N = 8  # kMaxN in csrc/gemv_tile.cuh: columns of x the kernels take


def gemv_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x``: a [M, K], x [K, N] -> [M, N], float32 accumulation, in a's dtype.

    A is read row-major whatever its strides, so the order of the sums (and
    the last bits of a float32 result) do not depend on A's layout.
    """
    return (a.float().contiguous() @ x.float()).to(a.dtype)


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
def _launch_fn():
    fn = build.load("gemv").gemv_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gemv_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors and return ``y[M, N]`` in a's dtype.

    Takes what :func:`check_operands` allows and raises on anything else, and
    on a launch the runtime refuses.  Each launch adds one to
    ``gemv_cuda.launches``.
    """
    col_major, lda = check_operands("gemv_cuda", a, x)
    M, K = a.shape
    N = x.shape[1]
    y = torch.empty(M, N, dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    status = _launch_fn()(a.data_ptr(), x.data_ptr(), y.data_ptr(), M, K, N, lda, col_major,
                          build.DTYPE_CODE[a.dtype], stream)
    if status != 0:
        raise RuntimeError(f"gemv kernel launch failed with CUDA error {status}")
    gemv_cuda.launches += 1
    return y


gemv_cuda.launches = 0
