"""Fused RMSNorm: the CUDA kernels' wrappers, their plain PyTorch versions,
and the autograd function that joins forward and backward.

Port of ``repro/kernels/rmsnorm.py``.  The kernel (``csrc/rmsnorm.cu``) runs
a CTA a row and makes one memory round trip: each thread loads its ``nv``
16-byte vectors of x and of gamma at once, into registers, and the row's sums
meet at one barrier.  :func:`rmsnorm_plan` chooses ``nv`` from the width;
:func:`rmsnorm_ref` is the same function in plain PyTorch, used on the CPU and
held against the kernel on the card.

The backward (:func:`rmsnorm_bwd_cuda`, the same source) is the port's own
kernel: the reference differentiates ``rms_norm`` through XLA.  It gives the
gradients that JAX's autodiff of ``repro/models/common.py::rms_norm`` gives
(:func:`rmsnorm_bwd_ref` in plain PyTorch), dgamma the same bits every run.
:class:`RMSNormFunction` runs the forward kernel and saves ``(x, gamma)``
for the backward kernel; ``kernels.ops.rmsnorm`` sends a CUDA tensor through
it whenever autograd records.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["rmsnorm_cuda", "rmsnorm_ref", "rmsnorm_plan", "rmsnorm_bwd_cuda", "rmsnorm_bwd_ref",
           "rmsnorm_bwd_plan", "RMSNormFunction"]

MAX_THREADS = 256      # threads a row (kMaxThreads in csrc/rmsnorm.cu)
VECTORS = (1, 2, 4, 8)  # 16-byte vectors of x a thread may hold
BWD_CTAS_PER_SM = 2    # the backward's CTAs an SM aims at (rmsnorm_bwd_plan)


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + gamma)`` in float32, in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dgamma)`` of :func:`rmsnorm_ref` for the output's gradient ``g``.

    In float32, with ``r = rsqrt(mean(x^2) + eps)`` and ``w = 1 + gamma``:
    ``dx = r * (g * w) - x * r^3 * mean(g * w * x)`` in x's dtype, and
    ``dgamma`` the float32 sum over rows of ``g * (x * r)`` in gamma's dtype.
    """
    x32, g32 = x.float(), g.float()
    w = 1.0 + gamma.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    gw = g32 * w
    dx = r * gw - x32 * (r * r * r * (gw * x32).mean(dim=-1, keepdim=True))
    dgamma = (g32 * (x32 * r)).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype)


def rmsnorm_bwd_plan(rows: int, sms: int) -> int:
    """Rows a CTA of the backward takes: consecutive runs that spread the rows
    over about ``BWD_CTAS_PER_SM`` CTAs an SM.  [2048, D] on 132 SMs: 8 rows,
    256 CTAs."""
    return max(1, -(-rows // (BWD_CTAS_PER_SM * sms)))


def rmsnorm_plan(d: int, element_size: int) -> int:
    """Vectors of x a thread holds for rows of ``d`` elements: the fewest of
    1, 2, 4, 8 with which up to 256 threads cover the row.  Raises for a row
    wider than that: bf16 D 16384, float32 D 8192."""
    nvec = d * element_size // 16
    for nv in VECTORS:
        if nvec <= nv * MAX_THREADS:
            return nv
    widest = MAX_THREADS * VECTORS[-1] * 16 // element_size
    raise ValueError(f"rmsnorm_cuda takes rows of at most {widest} elements of "
                     f"{element_size} bytes, got D = {d}")


@functools.cache
def _launch_fn():
    fn = build.load("rmsnorm").rmsnorm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, gamma: torch.Tensor, *more: torch.Tensor) -> int:
    """Raise unless the kernels take x, gamma (and ``more``, shaped as x); the
    vectors a thread holds."""
    if x.device.type != "cuda" or any(t.device != x.device for t in (gamma, *more)):
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"x on {x.device} and gamma on {gamma.device}")
    if x.dtype not in build.DTYPE_CODE or any(t.dtype != x.dtype for t in (gamma, *more)):
        raise ValueError(f"{name} takes float32 or bfloat16 x with gamma of "
                         f"the same dtype, got {x.dtype} and {gamma.dtype}")
    D = x.shape[-1]
    vec = 16 // x.element_size()
    if (gamma.shape != (D,) or D % vec != 0 or x.numel() == 0
            or any(t.shape != x.shape for t in more)):
        raise ValueError(f"{name} needs gamma [{D}] and D a multiple of {vec}, "
                         f"got x {tuple(x.shape)} and gamma {tuple(gamma.shape)}")
    if not all(t.is_contiguous() for t in (x, gamma, *more)):
        raise ValueError(f"{name} needs contiguous x and gamma")
    if any(t.data_ptr() % 16 for t in (x, gamma, *more)):
        raise ValueError(f"{name} needs 16-byte aligned x and gamma")
    return rmsnorm_plan(D, x.element_size())


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on ``x[..., D]`` (a CUDA tensor) and return y.

    Takes float32 or bfloat16, gamma of x's dtype and shape ``[D]``, both
    contiguous, D a multiple of 16 bytes and no wider than the kernel takes
    (:func:`rmsnorm_plan`).  Raises on anything else, and on a launch the
    runtime refuses.  Each launch adds one to ``rmsnorm_cuda.launches``.
    """
    nv = _check("rmsnorm_cuda", x, gamma)
    D = x.shape[-1]
    rows = x.numel() // D
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _launch_fn()(x.data_ptr(), gamma.data_ptr(), y.data_ptr(), rows, D,
                          float(eps), build.DTYPE_CODE[x.dtype], nv, stream)
    if status != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed with CUDA error {status}")
    rmsnorm_cuda.launches += 1
    return y


rmsnorm_cuda.launches = 0


@functools.cache
def _bwd_launch_fn():
    fn = build.load("rmsnorm").rmsnorm_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward on CUDA tensors: ``(dx, dgamma)`` for the output's
    gradient ``g`` (x's shape and dtype).

    Takes what :func:`rmsnorm_cuda` takes, g too.  Two launches, counted as
    one call in ``rmsnorm_bwd_cuda.launches``: the rows (dx, and each CTA's
    float32 dgamma partial in a workspace), then the partials summed in CTA
    order.  Raises on anything else, and on a launch the runtime refuses.
    """
    from .gemv import sm_count

    nv = _check("rmsnorm_bwd_cuda", x, gamma, g)
    D = x.shape[-1]
    rows = x.numel() // D
    per_cta = rmsnorm_bwd_plan(rows, sm_count(x.device))
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    partial = torch.empty((-(-rows // per_cta), D), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _bwd_launch_fn()(x.data_ptr(), gamma.data_ptr(), g.data_ptr(), dx.data_ptr(),
                              dgamma.data_ptr(), partial.data_ptr(), rows, D, float(eps),
                              build.DTYPE_CODE[x.dtype], nv, per_cta, stream)
    if status != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed with CUDA error {status}")
    rmsnorm_bwd_cuda.launches += 1
    return dx, dgamma


rmsnorm_bwd_cuda.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """``y = rmsnorm(x, gamma)`` with its gradients, through two given functions.

    ``apply(x, gamma, eps, (forward, backward))``: ``forward(x, gamma, eps)``
    gives y, ``backward(x, gamma, g, eps)`` gives ``(dx, dgamma)`` from the
    saved ``(x, gamma)``.  ``kernels.ops.rmsnorm`` passes the CUDA kernels;
    the CPU tests pass the plain versions to check the wiring.
    """

    @staticmethod
    def forward(ctx, x, gamma, eps, fns):
        ctx.save_for_backward(x, gamma)
        ctx.eps, ctx.backward_fn = eps, fns[1]
        return fns[0](x, gamma, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        dx, dgamma = ctx.backward_fn(x, gamma, g.contiguous(), ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dgamma if ctx.needs_input_grad[1] else None, None, None)
