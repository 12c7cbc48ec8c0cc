"""The port chain (``csrc/port_chain.cu``): the tiered solver's per-port busy
recurrence, float64, in numpy's order.

The port's own kernel; it replaces no TPU kernel.  The reference's tiered
lockstep solver (``repro/core/lockstep_tiered.py``, ``_chain``) prices each
link port's touches with the event engine's scalar recurrence
``start = max(ready, busy); busy = start + ser`` and adds the port's queued
time ``start - ready`` to its running total in order.  Its restart runs and
cumsum chunks reproduce the scalar sequence bit for bit; so does this walk,
one touch at a time.

Segments: ``rdy[offs[s]:offs[s + 1]]`` are the ready times of port
``port[s]``'s touches in queue order, each of serialization time ``ser[s]``.
:func:`port_chain` returns every touch's start and advances ``busy`` and
``qd`` (indexed by port) in place.  No two segments of one call may name the
same port.  It dispatches on the device: the kernel for CUDA tensors, the
plain version (:func:`port_chain_ref`, one step a touch index, vectorised
across the segments) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["port_chain", "port_chain_cuda", "port_chain_ref"]


def _check(name, rdy, offs, port, ser, busy, qd) -> None:
    f64, i64 = torch.float64, torch.int64
    ok = (rdy.dtype == f64 and ser.dtype == f64 and busy.dtype == f64 and qd.dtype == f64
          and offs.dtype == i64 and port.dtype == i64 and rdy.dim() == 1
          and offs.dim() == 1 and offs.numel() == port.numel() + 1
          and ser.shape == port.shape and busy.shape == qd.shape and busy.dim() == 1)
    if not ok:
        raise ValueError(
            f"{name} takes float64 rdy [T], int64 offs [S + 1], int64 port [S], "
            f"float64 ser [S] and float64 busy, qd [P]; got rdy {rdy.dtype} "
            f"{tuple(rdy.shape)}, offs {offs.dtype} {tuple(offs.shape)}, port "
            f"{port.dtype} {tuple(port.shape)}, ser {ser.dtype} {tuple(ser.shape)}, "
            f"busy {busy.dtype} {tuple(busy.shape)}, qd {qd.dtype} {tuple(qd.shape)}")


def port_chain_ref(rdy, offs, port, ser, busy, qd) -> torch.Tensor:
    """The plain version: segments sorted longest first, so the segments
    still walking at step ``j`` are a prefix; each step is one ``maximum``,
    one subtraction and two additions over that prefix."""
    _check("port_chain_ref", rdy, offs, port, ser, busy, qd)
    starts = torch.empty_like(rdy)
    lens = offs[1:] - offs[:-1]
    order = torch.sort(lens, descending=True, stable=True).indices
    lens_h = lens[order].tolist()
    base, prt, sr = offs[:-1][order], port[order], ser[order]
    b, q = busy[prt].clone(), qd[prt].clone()
    k = len(lens_h)
    for j in range(lens_h[0] if lens_h else 0):
        while lens_h[k - 1] <= j:
            k -= 1
        t = base[:k] + j
        r = rdy[t]
        st = torch.maximum(r, b[:k])
        starts[t] = st
        q[:k] = q[:k] + (st - r)
        b[:k] = st + sr[:k]
    busy[prt] = b
    qd[prt] = q
    return starts


@functools.cache
def _launch_fn():
    fn = build.load("port_chain").port_chain_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def port_chain_cuda(rdy, offs, port, ser, busy, qd) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (``busy`` and ``qd`` contiguous,
    updated in place).  Raises on anything else, and on a launch the runtime
    refuses.  Each launch adds one to ``port_chain_cuda.launches``."""
    _check("port_chain_cuda", rdy, offs, port, ser, busy, qd)
    if not all(t.is_cuda for t in (rdy, offs, port, ser, busy, qd)):
        raise ValueError("port_chain_cuda launches on CUDA tensors")
    if not (busy.is_contiguous() and qd.is_contiguous()):
        raise ValueError("port_chain_cuda updates busy and qd in place: pass contiguous tensors")
    rdy, offs, port, ser = (t.contiguous() for t in (rdy, offs, port, ser))
    starts = torch.empty_like(rdy)
    if port.numel() == 0:
        return starts
    stream = torch.cuda.current_stream(rdy.device).cuda_stream
    status = _launch_fn()(rdy.data_ptr(), offs.data_ptr(), port.data_ptr(), ser.data_ptr(),
                          busy.data_ptr(), qd.data_ptr(), starts.data_ptr(), port.numel(),
                          stream)
    if status != 0:
        raise RuntimeError(f"port_chain kernel launch failed with CUDA error {status}")
    port_chain_cuda.launches += 1
    return starts


port_chain_cuda.launches = 0


def port_chain(rdy, offs, port, ser, busy, qd) -> torch.Tensor:
    """Every touch's start; ``busy`` and ``qd`` advanced in place: the kernel
    on the card, the plain version on the CPU."""
    if rdy.is_cuda:
        return port_chain_cuda(rdy, offs, port, ser, busy, qd)
    return port_chain_ref(rdy, offs, port, ser, busy, qd)
