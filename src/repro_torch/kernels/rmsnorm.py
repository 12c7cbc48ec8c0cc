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
(:func:`rmsnorm_bwd_ref` in plain PyTorch), dgamma the same bits every run,
in one launch: each CTA takes a run of rows in blocks loaded at once, and
the last CTAs to finish sum the CTAs' dgamma rows (:func:`rmsnorm_bwd_plan`,
pure and CPU-tested, chooses the blocks, the runs and the reducers).
:class:`RMSNormFunction` runs the forward kernel and saves ``(x, gamma)``
for the backward kernel (the CPU tests pass it the plain versions).

The two kernels also have operators for the dry run (``launch/dryrun.py``),
``repro_torch::rmsnorm`` and ``repro_torch::rmsnorm_bwd`` (:func:`rmsnorm_op`,
:func:`rmsnorm_bwd_op`): shape functions only.  On the ``meta`` tensors each
allocates the outputs' shapes and launches nothing, and the dry run's
dispatch modes see one op a kernel call (``core/cost.py``);
``kernels.ops.rmsnorm`` passes them to :class:`RMSNormFunction` as its pair.
On any other tensor they raise: the card reaches the kernels through the
wrappers alone.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import build

__all__ = ["rmsnorm_cuda", "rmsnorm_ref", "rmsnorm_plan", "rmsnorm_bwd_cuda", "rmsnorm_bwd_ref",
           "rmsnorm_bwd_plan", "RMSNormBwdPlan", "rmsnorm_bwd_workspace", "RMSNormFunction",
           "rmsnorm_op", "rmsnorm_bwd_op"]

MAX_THREADS = 256      # threads a row (kMaxThreads in csrc/rmsnorm.cu)
VECTORS = (1, 2, 4, 8)  # 16-byte vectors of x a thread may hold
# the backward's, as csrc/rmsnorm.cu has them
BWD_BLOCKS = (1, 2, 4)  # rows a block may take
BWD_BLOCK_VECTORS = 4  # vectors of x a thread loads a block, past one row
BWD_CTAS_PER_SM = 2    # CTAs an SM the grid plans for before a CTA takes a second block
BWD_REDUCERS = 64      # the last CTAs to finish, which sum dgamma, at most


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


@dataclass(frozen=True)
class RMSNormBwdPlan:
    """One launch of the backward: ``ctas`` CTAs, each taking ``rows_per_cta``
    consecutive rows (the last ones fewer or none) in blocks of ``block`` rows,
    ``nv`` 16-byte vectors of a row a thread; the last ``reducers`` CTAs to
    finish sum dgamma, a chunk of columns each."""

    ctas: int
    rows_per_cta: int
    block: int
    nv: int
    reducers: int

    def threads(self, d: int, element_size: int) -> int:
        return (-(-(d * element_size // 16) // self.nv) + 31) // 32 * 32


@functools.lru_cache(maxsize=256)
def rmsnorm_bwd_plan(rows: int, d: int, element_size: int, sms: int) -> RMSNormBwdPlan:
    """The backward's launch for ``rows`` rows of ``d`` elements; pure, so it
    runs (and is tested) on the CPU.

    A thread holds the forward's ``nv`` vectors of a row (:func:`rmsnorm_plan`);
    a block is the most rows, of 1, 2, 4, whose loads a thread holds at once
    within ``BWD_BLOCK_VECTORS`` (one row where a row alone passes it); a CTA
    takes one block of consecutive rows, or more where the grid would pass
    ``BWD_CTAS_PER_SM`` CTAs an SM.  The last ``BWD_REDUCERS`` CTAs to finish
    (fewer where the grid or the row is smaller: at least 4 columns each) sum
    dgamma.  [2048, 1152] bf16 on 132 SMs: nv 1, blocks of 4 rows, 8 rows a
    CTA, 256 CTAs, 64 reducers of 20 columns (the last of 12).  The blocks and
    runs were chosen by a sweep on the card (``tools/rmsnorm_bwd_launches.py
    --plans``; PERF.md).
    """
    nv = rmsnorm_plan(d, element_size)
    if rows < 1 or sms < 1 or d * element_size % 16:
        raise ValueError(f"rmsnorm_bwd_plan takes rows >= 1, sms >= 1 and rows of whole "
                         f"16-byte vectors, got rows={rows}, d={d}, sms={sms}")
    block = max([1] + [b for b in BWD_BLOCKS if b * nv <= BWD_BLOCK_VECTORS])
    per_cta = block * -(-rows // (block * BWD_CTAS_PER_SM * sms))
    ctas = -(-rows // per_cta)
    return RMSNormBwdPlan(ctas=ctas, rows_per_cta=per_cta, block=block, nv=nv,
                          reducers=min(ctas, BWD_REDUCERS, d // 4))


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
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_BWD_WORKSPACES: dict = {}


def rmsnorm_bwd_workspace(device: torch.device, stream: int,
                          floats: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ws, tickets)`` of the backward's launches on one CUDA stream: float32
    room for the CTAs' dgamma rows, grown to at least ``floats``, and two
    int32 tickets (the CTAs done, the reducers past their wait), zeroed once
    when made; each launch leaves them at 0.  Kept a stream, so that launches
    on two streams never share them."""
    key = (device, stream)
    ws, tickets = _BWD_WORKSPACES.get(key, (None, None))
    if tickets is None:
        tickets = torch.zeros(2, dtype=torch.int32, device=device)
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    _BWD_WORKSPACES[key] = (ws, tickets)
    return ws, tickets


def rmsnorm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6, *,
                     plan: RMSNormBwdPlan | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward on CUDA tensors: ``(dx, dgamma)`` for the output's
    gradient ``g`` (x's shape and dtype).

    Takes what :func:`rmsnorm_cuda` takes, g too.  One launch, counted in
    ``rmsnorm_bwd_cuda.launches``, under ``plan`` (default
    :func:`rmsnorm_bwd_plan`).  Raises on anything else, on a plan that does
    not cover the rows, and on a launch the runtime refuses.
    """
    from .gemv import sm_count

    _check("rmsnorm_bwd_cuda", x, gamma, g)
    D = x.shape[-1]
    rows = x.numel() // D
    if plan is None:
        plan = rmsnorm_bwd_plan(rows, D, x.element_size(), sm_count(x.device))
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws, tickets = rmsnorm_bwd_workspace(x.device, stream, plan.ctas * D)
    status = _bwd_launch_fn()(x.data_ptr(), gamma.data_ptr(), g.data_ptr(), dx.data_ptr(),
                              dgamma.data_ptr(), ws.data_ptr(), tickets.data_ptr(), rows, D,
                              float(eps), build.DTYPE_CODE[x.dtype], plan.nv, plan.block,
                              plan.rows_per_cta, plan.ctas, plan.reducers, stream)
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


def _shapes_only(name: str, x: torch.Tensor):
    raise RuntimeError(f"repro_torch::{name} is the dry run's shape function; a {x.device} "
                       "tensor takes the kernel's wrapper (kernels.ops.rmsnorm)")


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def rmsnorm_op(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`rmsnorm_cuda`'s shape, on ``meta`` tensors only."""
    _shapes_only("rmsnorm", x)


@rmsnorm_op.register_fake
def _rmsnorm_shape(x, gamma, eps):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::rmsnorm_bwd", mutates_args=())
def rmsnorm_bwd_op(x: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor,
                   eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rmsnorm_bwd_cuda`'s shapes ``(dx, dgamma)``, on ``meta`` tensors only."""
    _shapes_only("rmsnorm_bwd", x)


@rmsnorm_bwd_op.register_fake
def _rmsnorm_bwd_shape(x, gamma, g, eps):
    return torch.empty_like(x), torch.empty_like(gamma)
