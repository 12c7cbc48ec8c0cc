"""One Mamba2 decode step in one launch: the CUDA kernel's wrapper, its
plain version and its shape function.

The kernel (``csrc/mamba_decode.cu``) takes a Mamba2 block from the token's
projection ``[B, 1, z | xBC | dt]`` to the gated ``y`` that goes into
``w_out``: the streaming conv over the float32 window, ``dt`` and the decay,
the float32 state update, ``y = h . C + D x`` and the gate, each rounded
where :func:`mamba_decode_ref` rounds it.  That plain version has the
kernel's signature: the CPU path, the card tests' reference, and what a
float64 run on the card takes in the kernel's place.  ``h`` is updated in
place; the window moved on by one token comes back as a new tensor.

The operator ``repro_torch::mamba_decode`` is the kernel's shape function
for the dry run's ``meta`` tensors (``kernels/ops.py``); it launches nothing
and raises on any other tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

__all__ = ["mamba_decode_cuda", "mamba_decode_op", "mamba_decode_ref", "STATE_SIZES", "MAX_HEAD_DIM", "MAX_TAPS"]

STATE_SIZES = (16, 32, 64, 128)  # d_state the kernel is built for
MAX_HEAD_DIM = 64                # kMaxHeadDim: rows of a CTA's tile
MAX_TAPS = 8                     # kMaxK: conv taps


@functools.cache
def _launch_fn():
    fn = build.load("mamba_decode").mamba_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z) -> None:
    """Raise unless the kernel takes these operands (plain attribute checks:
    they run on the host for every Mamba2 layer of every step)."""
    name = "mamba_decode_cuda"
    ts = (proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z)
    if proj.device.type != "cuda" or any(t.device != proj.device for t in ts):
        raise ValueError(f"{name} needs CUDA tensors on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError(f"{name} has no backward: call it under torch.no_grad() "
                         "(training and prefill take models/ssm.py::_ssm_scan)")
    if proj.dtype not in build.DTYPE_CODE or conv_w.dtype != proj.dtype \
            or norm_z.dtype != proj.dtype:
        raise ValueError(f"{name} takes a float32 or bfloat16 projection with conv_w and "
                         f"norm_z of its dtype, got {proj.dtype}, {conv_w.dtype}, {norm_z.dtype}")
    if any(t.dtype != torch.float32 for t in (conv, h, dt_bias, a_log, d_skip)):
        raise ValueError(f"{name} takes float32 h, conv, dt_bias, a_log and d_skip")
    if h.dim() != 4:
        raise ValueError(f"{name} needs h [B, H, d_head, d_state], got {tuple(h.shape)}")
    B, H, dh, ds = h.shape
    d_inner = H * dh
    C = d_inner + 2 * ds
    K = conv_w.shape[0]
    if ds not in STATE_SIZES or not 1 <= dh <= MAX_HEAD_DIM or not 2 <= K <= MAX_TAPS:
        raise ValueError(f"{name} takes d_state in {STATE_SIZES}, d_head <= {MAX_HEAD_DIM} and "
                         f"2 to {MAX_TAPS} conv taps, got h {tuple(h.shape)} and {K} taps")
    if (proj.shape != (B, 1, 2 * d_inner + 2 * ds + H) or conv.shape != (B, K - 1, C)
            or conv_w.shape != (K, C) or norm_z.shape != (d_inner,)
            or any(t.shape != (H,) for t in (dt_bias, a_log, d_skip))):
        raise ValueError(f"{name} does not take proj {tuple(proj.shape)}, conv "
                         f"{tuple(conv.shape)}, conv_w {tuple(conv_w.shape)}, norm_z "
                         f"{tuple(norm_z.shape)} with h {tuple(h.shape)}")
    if not (h.is_contiguous() and proj.is_contiguous() and conv_w.is_contiguous()
            and norm_z.is_contiguous() and dt_bias.is_contiguous() and a_log.is_contiguous()
            and d_skip.is_contiguous()) or conv.stride()[1:] != (C, 1):
        raise ValueError(f"{name} needs a contiguous state h (updated in place), projection "
                         "and weights, and conv window rows packed")
    if h.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned h")


def mamba_decode_cuda(proj: torch.Tensor, conv: torch.Tensor, h: torch.Tensor,
                      conv_w: torch.Tensor, dt_bias: torch.Tensor, a_log: torch.Tensor,
                      d_skip: torch.Tensor, norm_z: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel (CUDA tensors): ``(y [B, 1, d_inner] in proj's
    dtype, conv [B, K - 1, C] float32)``, ``h`` updated in place.

    ``proj [B, 1, z | x B C | dt]`` float32 or bfloat16, contiguous; ``conv``
    the float32 window ``[B, K - 1, C]`` (C = d_inner + 2 d_state; each row
    packed, rows at any stride); ``h`` float32 ``[B, H, d_head, d_state]``,
    contiguous; ``conv_w [K, C]`` and ``norm_z [d_inner]`` of proj's dtype;
    ``dt_bias``, ``a_log``, ``d_skip`` float32 ``[H]``.  The heads are h's:
    all of them, or a rank's.  Takes d_state 16, 32, 64 or 128, d_head up to
    64, 2 to 8 taps, and no tensor that records grad.  Raises on anything
    else, and on a launch the runtime refuses.  Each launch adds one to
    ``mamba_decode_cuda.launches``.
    """
    _check(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z)
    B, H, dh, ds = h.shape
    K, C = conv_w.shape
    y = torch.empty(B, 1, H * dh, dtype=proj.dtype, device=proj.device)
    conv_out = torch.empty(B, K - 1, C, dtype=torch.float32, device=proj.device)
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    status = _launch_fn()(proj.data_ptr(), conv.data_ptr(), h.data_ptr(), conv_w.data_ptr(),
                          dt_bias.data_ptr(), a_log.data_ptr(), d_skip.data_ptr(),
                          norm_z.data_ptr(), y.data_ptr(), conv_out.data_ptr(), B, H, dh, ds, K,
                          proj.stride(0), conv.stride(0), build.DTYPE_CODE[proj.dtype], stream)
    if status != 0:
        raise RuntimeError(f"mamba_decode kernel launch failed with CUDA error {status}")
    mamba_decode_cuda.launches += 1
    return y, conv_out


mamba_decode_cuda.launches = 0


def mamba_decode_ref(proj: torch.Tensor, conv: torch.Tensor, h: torch.Tensor,
                     conv_w: torch.Tensor, dt_bias: torch.Tensor, a_log: torch.Tensor,
                     d_skip: torch.Tensor, norm_z: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_decode_cuda` in plain torch, on any device and float
    dtype: ``(y [B, 1, d_inner] in proj's dtype, the window moved on by one
    token)``, ``h`` updated in place.

    The conv, ``dt``, the decay and the state run in float32 (the window and
    ``h`` keep their own dtype), the conv's output and ``y`` are rounded to
    proj's dtype, and the gate runs in it: the recurrence's step is
    ``models/ssm.py::_ssm_step``'s, op for op.
    """
    B, H, dh, ds = h.shape
    d_inner = H * dh
    z, xbc_t, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * ds, H], dim=-1)
    # the streaming depthwise conv: window = [conv state, current], float32
    win = torch.cat([conv, xbc_t.to(conv.dtype)], dim=1)  # [B, K, C]
    xbc = F.silu(torch.einsum("bkc,kc->bc", win.float(), conv_w.float())).to(proj.dtype)
    x, Bm, Cm = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    dt = F.softplus(dt_raw[:, 0].float() + dt_bias)
    xt = x.reshape(B, H, dh).float()
    decay = torch.exp(-torch.exp(a_log.float())[None, :] * dt)[..., None, None]
    upd = (dt[..., None, None] * xt[..., :, None]) * Bm.float()[:, None, None, :]
    h.copy_(h * decay + upd)
    y = torch.einsum("bhds,bs->bhd", h, Cm.float()) + d_skip.float()[None, :, None] * xt
    y = y.reshape(B, 1, d_inner).to(proj.dtype)
    return y * F.silu(z + norm_z), win[:, 1:]


@torch.library.custom_op("repro_torch::mamba_decode", mutates_args=("h",))
def mamba_decode_op(proj: torch.Tensor, conv: torch.Tensor, h: torch.Tensor,
                    conv_w: torch.Tensor, dt_bias: torch.Tensor, a_log: torch.Tensor,
                    d_skip: torch.Tensor, norm_z: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_decode_cuda`'s shapes ``(y, conv)``, on ``meta`` tensors only."""
    raise RuntimeError(f"repro_torch::mamba_decode is the dry run's shape function; a "
                       f"{proj.device} tensor takes the kernel's wrapper (kernels.ops)")


@mamba_decode_op.register_fake
def _mamba_decode_shape(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z):
    K, C = conv_w.shape
    return (proj.new_empty(proj.shape[0], 1, norm_z.shape[0]),
            conv.new_empty(proj.shape[0], K - 1, C))
