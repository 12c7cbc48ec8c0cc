"""Fused RMSNorm: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/rmsnorm.py``.  The kernel (``csrc/rmsnorm.cu``) runs
one CTA per row; :func:`rmsnorm_ref` is the same function in plain PyTorch,
used on the CPU and held against the kernel on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["rmsnorm_cuda", "rmsnorm_ref"]


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + gamma)`` in float32, in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(x.dtype)


@functools.cache
def _launch_fn():
    fn = build.load("rmsnorm").rmsnorm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on ``x[..., D]`` (a CUDA tensor) and return y.

    Takes float32 or bfloat16, gamma of x's dtype and shape ``[D]``, both
    contiguous, D a multiple of 16 bytes.  Raises on anything else, and on a
    launch the runtime refuses.  Each launch adds one to ``rmsnorm_cuda.launches``.
    """
    if x.device.type != "cuda" or gamma.device != x.device:
        raise ValueError(f"rmsnorm_cuda needs CUDA tensors on one device, got "
                         f"x on {x.device} and gamma on {gamma.device}")
    if x.dtype not in build.DTYPE_CODE or gamma.dtype != x.dtype:
        raise ValueError(f"rmsnorm_cuda takes float32 or bfloat16 x with gamma of "
                         f"the same dtype, got {x.dtype} and {gamma.dtype}")
    D = x.shape[-1]
    vec = 16 // x.element_size()
    if gamma.shape != (D,) or D % vec != 0 or x.numel() == 0:
        raise ValueError(f"rmsnorm_cuda needs gamma [{D}] and D a multiple of {vec}, "
                         f"got x {tuple(x.shape)} and gamma {tuple(gamma.shape)}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and gamma")
    if x.data_ptr() % 16 or gamma.data_ptr() % 16:
        raise ValueError("rmsnorm_cuda needs 16-byte aligned x and gamma")
    rows = x.numel() // D
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _launch_fn()(x.data_ptr(), gamma.data_ptr(), y.data_ptr(), rows, D,
                          float(eps), build.DTYPE_CODE[x.dtype], stream)
    if status != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed with CUDA error {status}")
    rmsnorm_cuda.launches += 1
    return y


rmsnorm_cuda.launches = 0
