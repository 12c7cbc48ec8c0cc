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

Under a bound mesh (a sharded model) the mLSTM cell computes the rank's
heads where ``model`` divides them and the ``heads`` and ``mlp`` rules cut
every weight over it (:func:`mlstm_head_parallel`; the caller decides, and
passes the mesh only then).  ``w_q``, ``w_k``, ``w_v``, ``w_if`` (its 2H
columns are (head, gate) pairs) and ``w_down``'s rows are the rank's heads'
as they lie.  ``w_up`` ``[x_m | z]`` is cut over ``mlp`` contiguously,
across the two halves, and every head reads all of x_m (the input of q, k
and v).  The full pass (training, prefill) gathers it and takes x_m's
columns and its heads' part of z's (:func:`mlstm_columns`), so x_m's
product is each rank's whole, a named duplicate; the gradient is one
reduce-scatter over ``model``.  A decode step projects its token on the
rank's own columns and gathers every column of the projection over
``model`` instead.  The input's gradient is summed over ``model`` on entry,
and the output is summed over ``model`` after ``w_down``'s rows; the state
is the rank's heads'.  The sLSTM cell stays whole on every rank from
gathered weights: its recurrent ``r_zifo`` is dense over the width, so a cut
of its columns would take one exchange over ``model`` at every step of the
scan.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..distributed.collectives import copy_in, gather, raw_all_gather, reduce_out
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
    "mlstm_head_parallel",
    "mlstm_columns",
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


def init_mlstm_state(cfg: ModelConfig, batch: int, device: torch.device,
                     parts: int = 1) -> Dict[str, torch.Tensor]:
    """The initial state; ``parts``: the ranks the heads are cut over."""
    H = cfg.n_heads // parts
    dh = cfg.d_model // cfg.n_heads
    return {
        "C": torch.zeros(batch, H, dh, dh, device=device),
        "n": torch.zeros(batch, H, dh, device=device),
        "m": torch.full((batch, H), -1e30, device=device),
    }


def mlstm_head_parallel(cfg: ModelConfig, specs: Dict[str, tuple], mesh) -> bool:
    """Whether the rank computes its own heads: ``model`` divides them and
    cuts every weight (see the module's doc)."""
    m = mesh.axis_size("model")
    return (m > 1 and cfg.n_heads % m == 0
            and all(specs.get(k) == (None, "model") for k in ("w_up", "w_q", "w_k", "w_v", "w_if"))
            and specs.get("w_down") == ("model",))


def _z_columns(cfg: ModelConfig, mesh) -> torch.Tensor:
    """The indices of the rank's heads' columns of z in ``[x_m | z]``."""
    d, m, r = cfg.d_model, mesh.axis_size("model"), mesh.index("model")
    return d + r * (d // m) + torch.arange(d // m)


def mlstm_columns(cfg: ModelConfig, p, mesh) -> Dict[str, torch.Tensor]:
    """``{"w_up"}``: all of x_m's columns and the rank's heads' part of z's,
    from the weight gathered over ``model``, its gradient reduce-scattered
    over it."""
    w_up = gather(p["w_up"], mesh, "model", 1, partial=True)
    cols = torch.cat([torch.arange(cfg.d_model), _z_columns(cfg, mesh)])
    return {"w_up": w_up.index_select(1, cols.to(w_up.device))}


def _mlstm_gates(cfg: ModelConfig, p, x_m: torch.Tensor):
    """``(q, k, v, input gate, forget gate)``, float32: q, k, v [B, S, H, dh]
    of the heads ``p`` holds (all, or a rank's)."""
    B, S, _ = x_m.shape
    H = p["w_if"].shape[1] // 2
    dh = cfg.d_model // cfg.n_heads
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
                return_state: bool = False, mesh=None):
    """x [B, S, d] -> y [B, S, d]; with ``return_state`` also the state after
    the last token.  With a bound ``mesh`` (the caller checked
    :func:`mlstm_head_parallel`), ``p`` holds this rank's shards and the
    state is its heads' (see the module's doc)."""
    if mesh is not None:
        p = {**p, **mlstm_columns(cfg, p, mesh)}
        out = mlstm_apply(cfg, p, copy_in(x, mesh, "model"), return_state=return_state)
        if return_state:
            return reduce_out(out[0], mesh, "model"), out[1]
        return reduce_out(out, mesh, "model")
    B, S, d = x.shape
    x_m, z = torch.split(x @ p["w_up"], [d, p["w_up"].shape[1] - d], dim=-1)
    q, k, v, ig, fg = _mlstm_gates(cfg, p, x_m)
    st = init_mlstm_state(cfg, B, x.device, 2 * cfg.n_heads // p["w_if"].shape[1])
    C, n, m = st["C"], st["n"], st["m"]
    hs = []
    for t in range(S):
        C, n, m, h = _mlstm_step(C, n, m, q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, -1).to(x.dtype)
    out = (h * F.silu(z)) @ p["w_down"]
    if return_state:
        return out, {"C": C, "n": n, "m": m}
    return out


def mlstm_decode(cfg: ModelConfig, p, x: torch.Tensor, state: Dict[str, torch.Tensor], *,
                 mesh=None):
    """One token, x [B, 1, d] -> ``(y [B, 1, d], state)``, the state updated in
    place.  With a bound ``mesh`` (the caller checked
    :func:`mlstm_head_parallel`), ``p`` holds this rank's shards and ``state``
    its heads' (see the module's doc)."""
    d = x.shape[-1]
    up = x @ p["w_up"]
    if mesh is not None:  # every column of [x_m | z], from each rank's own
        up = raw_all_gather(up, mesh, "model", dim=-1)
        x_m, z = up[..., :d], up.index_select(-1, _z_columns(cfg, mesh).to(x.device))
    else:
        x_m, z = up[..., :d], up[..., d:]
    q, k, v, ig, fg = _mlstm_gates(cfg, p, x_m)
    C, n, m, h = _mlstm_step(state["C"], state["n"], state["m"],
                             q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0])
    state.update(C=C, n=n, m=m)
    h = h.reshape(x.shape[0], 1, -1).to(x.dtype)
    y = (h * F.silu(z)) @ p["w_down"]
    return (y if mesh is None else reduce_out(y, mesh, "model")), state


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
