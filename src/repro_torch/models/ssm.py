"""Mamba2-style selective SSM block, zamba2's recurrent backbone (port of
``repro.models.ssm``).

A simplified SSD formulation with ngroups=1 (B and C shared across heads):
the input projection gives (z, x, B, C, dt); a depthwise causal conv primes
x, B and C; the recurrence

    h_t = exp(-softplus(a) * dt_t) * h_{t-1} + dt_t * (x_t outer B_t)
    y_t = h_t @ C_t + D * x_t

runs as a plain loop over time for the full forward and prefill (the
reference's ``lax.scan``; it is no Pallas kernel there, so none here) and as
one update for decode.  State per layer: ``h [B, heads, 64, d_state]`` and the
conv window ``conv [B, K - 1, d_inner + 2 d_state]``, both float32 whatever
the parameter dtype.

Rounding follows the reference's: the prefill conv sums its K taps in the
activation dtype, one rounding per multiply and add (as XLA does on the CPU,
eager or jitted), while decode sums them in float32 over a float32 window.
So in bf16 the reference's prefill and its token-by-token decode differ, and
each port path keeps its own rounding.  ``norm_z`` is added inside the SiLU
gate; it is not a norm.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, ParamSpec

__all__ = ["mamba_specs", "mamba_apply", "mamba_decode", "init_ssm_state"]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = max(1, d_inner // 64)  # 64-wide heads (Mamba2 convention)
    return d_inner, n_heads, d_inner // n_heads


def _proj_cols(cfg: ModelConfig) -> int:
    d_inner, n_heads, _ = _dims(cfg)
    return 2 * d_inner + 2 * cfg.ssm_state + n_heads  # z, x, B, C, dt


def mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, pd = cfg.d_model, cfg.param_dtype
    d_inner, n_heads, _ = _dims(cfg)
    ds = cfg.ssm_state
    return {
        "w_in": ParamSpec((d, _proj_cols(cfg)), ("embed", "mlp"), pd),
        "conv_w": ParamSpec((cfg.ssm_conv, d_inner + 2 * ds), ("conv", "mlp"), pd),
        "a_log": ParamSpec((n_heads,), ("heads",), torch.float32, init="zeros"),
        "d_skip": ParamSpec((n_heads,), ("heads",), torch.float32, init="ones"),
        "dt_bias": ParamSpec((n_heads,), ("heads",), torch.float32, init="zeros"),
        "w_out": ParamSpec((d_inner, d), ("mlp", "embed"), pd),
        "norm_z": ParamSpec((d_inner,), ("mlp",), pd, init="zeros"),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """``(z, xbc, dt)`` of the input projection."""
    d_inner, n_heads, _ = _dims(cfg)
    return torch.split(proj, [d_inner, d_inner + 2 * cfg.ssm_state, n_heads], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time, then SiLU. xbc: [B, S, C]; w: [K, C].

    The taps are summed in xbc's dtype, rounding after each multiply and add.
    """
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(K):
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out)


def init_ssm_state(cfg: ModelConfig, batch: int, device: torch.device) -> Dict[str, torch.Tensor]:
    d_inner, n_heads, d_head = _dims(cfg)
    return {
        "h": torch.zeros(batch, n_heads, d_head, cfg.ssm_state, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, d_inner + 2 * cfg.ssm_state, device=device),
    }


def _ssm_step(h, xt, bt, ct, dtt, a, d_skip):
    """One step of the recurrence, float32: ``(h, y_t)``.

    xt: [B, H, Dh]; bt / ct: [B, ds]; dtt: [B, H]; h: [B, H, Dh, ds].
    """
    decay = torch.exp(-a[None, :] * dtt)[..., None, None]
    upd = (dtt[..., None, None] * xt[..., :, None]) * bt[:, None, None, :]
    h = h * decay + upd
    return h, torch.einsum("bhds,bs->bhd", h, ct) + d_skip[None, :, None] * xt


def _ssm_scan(cfg: ModelConfig, x, Bm, Cm, dt, a, d_skip):
    """x: [B, S, H, Dh]; Bm / Cm: [B, S, ds]; dt: [B, S, H] -> (y [B, S, H, Dh], h)."""
    B, S = x.shape[:2]
    _, n_heads, d_head = _dims(cfg)
    x, Bm, Cm, dt = x.float(), Bm.float(), Cm.float(), dt.float()
    h = torch.zeros(B, n_heads, d_head, cfg.ssm_state, device=x.device)
    ys = []
    for t in range(S):
        h, yt = _ssm_step(h, x[:, t], Bm[:, t], Cm[:, t], dt[:, t], a, d_skip)
        ys.append(yt)
    return torch.stack(ys, dim=1), h


def mamba_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], u: torch.Tensor, *,
                return_state: bool = False):
    """u: [B, S, d_model] -> y [B, S, d_model] (full forward / prefill);
    with ``return_state`` also the state after the last token."""
    B, S, _ = u.shape
    d_inner, n_heads, d_head = _dims(cfg)
    ds = cfg.ssm_state
    z, xbc_raw, dt_raw = _split_proj(cfg, u @ p["w_in"])
    xbc = _causal_conv(xbc_raw, p["conv_w"])
    x, Bm, Cm = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = torch.exp(p["a_log"].float())
    y, h = _ssm_scan(cfg, x.reshape(B, S, n_heads, d_head), Bm, Cm, dt, a, p["d_skip"].float())
    y = y.reshape(B, S, d_inner).to(u.dtype)
    out = (y * F.silu(z + p["norm_z"])) @ p["w_out"]
    if not return_state:
        return out
    K = cfg.ssm_conv
    conv_tail = F.pad(xbc_raw, (0, 0, K - 1, 0))[:, S:].float()  # the last K - 1 inputs
    return out, {"h": h, "conv": conv_tail}


def mamba_decode(cfg: ModelConfig, p: Dict[str, torch.Tensor], u: torch.Tensor,
                 state: Dict[str, torch.Tensor]):
    """One token, u: [B, 1, d_model] -> ``(y [B, 1, d_model], state)``.

    ``state`` is updated in place: its ``h`` and ``conv`` entries are replaced
    by the new state, and the same dict is returned.
    """
    B = u.shape[0]
    d_inner, n_heads, d_head = _dims(cfg)
    ds = cfg.ssm_state
    z, xbc_t, dt_raw = _split_proj(cfg, u @ p["w_in"])
    # the streaming depthwise conv: window = [conv state, current], float32
    win = torch.cat([state["conv"], xbc_t[:, :1].to(state["conv"].dtype)], dim=1)  # [B, K, C]
    conv_out = F.silu(torch.einsum("bkc,kc->bc", win.float(), p["conv_w"].float())).to(u.dtype)
    x, Bm, Cm = torch.split(conv_out, [d_inner, ds, ds], dim=-1)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    a = torch.exp(p["a_log"].float())
    h, y = _ssm_step(state["h"], x.reshape(B, n_heads, d_head).float(), Bm.float(), Cm.float(),
                     dt, a, p["d_skip"].float())
    y = y.reshape(B, 1, d_inner).to(u.dtype)
    state["h"], state["conv"] = h, win[:, 1:]
    return (y * F.silu(z + p["norm_z"])) @ p["w_out"], state
