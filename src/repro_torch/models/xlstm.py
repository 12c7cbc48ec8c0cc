"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
recurrent memory mixing), with exponential gating and a stabiliser state
(port of ``repro.models.xlstm``).

The layer pattern comes from ``cfg.xlstm_pattern`` ('m' / 's' a layer).
xlstm-125m has d_ff = 0: the blocks carry their own projections.  The
reference's ``lax.scan`` over time is a plain loop here (no Pallas kernel
there, so none here).  Every state is float32: mLSTM's ``m`` starts at
-1e30, sLSTM's ``n`` at 1.  ``w_if`` is float32, so the gate product runs in
float32 on the activations cast up, as JAX's type promotion does; sLSTM's
recurrent product casts ``h_prev`` to the activation dtype first.  The decode
functions update their state dict in place (its entries are replaced) and
return it.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import ModelConfig, ParamSpec

__all__ = [
    "mlstm_specs",
    "slstm_specs",
    "mlstm_apply",
    "slstm_apply",
    "mlstm_decode",
    "slstm_decode",
    "init_mlstm_state",
    "init_slstm_state",
]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, pd = cfg.d_model, cfg.n_heads, cfg.param_dtype
    return {
        "w_up": ParamSpec((d, 2 * d), ("embed", "mlp"), pd),
        "w_q": ParamSpec((d, d), ("embed", "heads"), pd),
        "w_k": ParamSpec((d, d), ("embed", "heads"), pd),
        "w_v": ParamSpec((d, d), ("embed", "heads"), pd),
        "w_if": ParamSpec((d, 2 * H), ("embed", "heads"), torch.float32),
        "w_down": ParamSpec((d, d), ("heads", "embed"), pd),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, device: torch.device) -> Dict[str, torch.Tensor]:
    H = cfg.n_heads
    dh = cfg.d_model // H
    return {
        "C": torch.zeros(batch, H, dh, dh, device=device),
        "n": torch.zeros(batch, H, dh, device=device),
        "m": torch.full((batch, H), -1e30, device=device),
    }


def _mlstm_gates(cfg: ModelConfig, p, x_m: torch.Tensor):
    """``(q, k, v, input gate, forget gate)``, float32: q, k, v [B, S, H, dh]."""
    B, S, d = x_m.shape
    H = cfg.n_heads
    dh = d // H
    q = (x_m @ p["w_q"]).reshape(B, S, H, dh).float() * (dh ** -0.5)
    k = (x_m @ p["w_k"]).reshape(B, S, H, dh).float() * (dh ** -0.5)
    v = (x_m @ p["w_v"]).reshape(B, S, H, dh).float()
    gif = (x_m.float() @ p["w_if"]).reshape(B, S, H, 2)
    return q, k, v, gif[..., 0], gif[..., 1]


def _mlstm_step(C, n, m, q, k, v, ig, fg):
    """One step: ``(C, n, m, h)``; q, k, v [B, H, dh], ig, fg [B, H]."""
    m_new = torch.maximum(fg + m, ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(fg + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", C, q)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), min=1.0)
    return C, n, m_new, num / den[..., None]


def mlstm_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
                return_state: bool = False):
    B, S, d = x.shape
    x_m, z = torch.chunk(x @ p["w_up"], 2, dim=-1)
    q, k, v, ig, fg = _mlstm_gates(cfg, p, x_m)
    st = init_mlstm_state(cfg, B, x.device)
    C, n, m = st["C"], st["n"], st["m"]
    hs = []
    for t in range(S):
        C, n, m, h = _mlstm_step(C, n, m, q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    out = (h * F.silu(z)) @ p["w_down"]
    if return_state:
        return out, {"C": C, "n": n, "m": m}
    return out


def mlstm_decode(cfg: ModelConfig, p, x: torch.Tensor, state: Dict[str, torch.Tensor]):
    """One token, x [B, 1, d] -> ``(y [B, 1, d], state)``, the state updated in place."""
    B, _, d = x.shape
    x_m, z = torch.chunk(x @ p["w_up"], 2, dim=-1)
    q, k, v, ig, fg = _mlstm_gates(cfg, p, x_m)
    C, n, m, h = _mlstm_step(state["C"], state["n"], state["m"],
                             q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0])
    state.update(C=C, n=n, m=m)
    h = h.reshape(B, 1, d).to(x.dtype)
    return (h * F.silu(z)) @ p["w_down"], state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, pd = cfg.d_model, cfg.param_dtype
    return {
        "w_zifo": ParamSpec((d, 4 * d), ("embed", "mlp"), pd),
        # recurrent memory mixing: dense, as in the reference
        "r_zifo": ParamSpec((d, 4 * d), ("embed", "mlp"), pd, scale=0.1),
        "w_out": ParamSpec((d, d), ("embed", "embed2"), pd),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device: torch.device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return {
        "c": torch.zeros(batch, d, device=device),
        "n": torch.ones(batch, d, device=device),
        "m": torch.zeros(batch, d, device=device),
        "h": torch.zeros(batch, d, device=device),
    }


def _slstm_step(p, c, n, m, h_prev, wx):
    """One step: ``(c, n, m, h)``; wx [B, 4d] in the activation dtype."""
    rec = (h_prev.to(wx.dtype) @ p["r_zifo"]).float()
    z_r, i_r, f_r, o_r = torch.chunk(wx.float() + rec, 4, dim=-1)
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    m_new = torch.maximum(f_r + m, i_r)
    i_p = torch.exp(i_r - m_new)
    f_p = torch.exp(f_r + m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    return c, n, m_new, o * (c / torch.clamp(torch.abs(n), min=1.0))


def slstm_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
                return_state: bool = False):
    B, S, _ = x.shape
    wx = x @ p["w_zifo"]  # [B, S, 4d]
    st = init_slstm_state(cfg, B, x.device)
    c, n, m, h = st["c"], st["n"], st["m"], st["h"]
    hs = []
    for t in range(S):
        c, n, m, h = _slstm_step(p, c, n, m, h, wx[:, t])
        hs.append(h)
    out = torch.stack(hs, dim=1).to(x.dtype) @ p["w_out"]
    if return_state:
        return out, {"c": c, "n": n, "m": m, "h": h}
    return out


def slstm_decode(cfg: ModelConfig, p, x: torch.Tensor, state: Dict[str, torch.Tensor]):
    """One token, x [B, 1, d] -> ``(y [B, 1, d], state)``, the state updated in place."""
    wx = (x @ p["w_zifo"])[:, 0]
    c, n, m, h = _slstm_step(p, state["c"], state["n"], state["m"], state["h"], wx)
    state.update(c=c, n=n, m=m, h=h)
    return h[:, None, :].to(x.dtype) @ p["w_out"], state
