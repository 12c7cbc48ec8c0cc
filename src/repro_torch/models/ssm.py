"""Mamba2-style selective SSM block, zamba2's recurrent backbone (port of
``repro.models.ssm``).

A simplified SSD formulation with ngroups=1 (B and C shared across heads):
the input projection gives (z, x, B, C, dt); a depthwise causal conv primes
x, B and C; the recurrence

    h_t = exp(-softplus(a) * dt_t) * h_{t-1} + dt_t * (x_t outer B_t)
    y_t = h_t @ C_t + D * x_t

runs as a plain loop over time for the full forward and prefill (the
reference's ``lax.scan``; it is no Pallas kernel there, so none here) and as
one update for decode: one call for everything between the two projections
(``kernels.ops.mamba_decode``: on the card a hand-written kernel, elsewhere
its plain version), ``h`` updated in place.  State per layer:
``h [B, heads, 64, d_state]`` and the conv window
``conv [B, K - 1, d_inner + 2 d_state]``, both float32 whatever the
parameter dtype.

Rounding follows the reference's: the prefill conv sums its K taps in the
activation dtype, one rounding per multiply and add (as XLA does on the CPU,
eager or jitted), while decode sums them in float32 over a float32 window.
So in bf16 the reference's prefill and its token-by-token decode differ, and
each port path keeps its own rounding.  ``norm_z`` is added inside the SiLU
gate; it is not a norm.

Under a bound mesh (a sharded model) the block computes the rank's heads
where ``model`` divides them and the ``heads`` and ``mlp`` rules cut every
weight over it (:func:`mamba_head_parallel`; the caller decides, and passes
the mesh only then).  ``a_log``, ``d_skip``, ``dt_bias``, ``norm_z`` and
``w_out``'s rows are the rank's heads' as they lie, since d_inner / model is
a whole number of 64-wide heads.  ``w_in`` ``[d, z | x | B | C | dt]`` and
``conv_w`` ``[K, x | B | C]`` are cut over ``mlp`` contiguously, which does
not line up with their segments; the rank needs its heads' z, x and dt and
all of B and C (ngroups 1: every head reads them).  The full pass (training,
prefill) gathers both weights and takes those columns
(:func:`mamba_columns`), so the B and C products are each rank's whole, a
named duplicate; their gradient is one reduce-scatter over ``model`` (each
rank's is its columns' part).  A decode step moves activations instead of
weights: each rank projects its token on its own columns of ``w_in``, and
one all-gather over ``model`` brings every column of the projection and of
``conv_w``.  The input's gradient is summed over ``model`` on entry, and the
output is summed over ``model`` after ``w_out``'s rows.  The state is the
rank's heads' ``h`` and the conv window of the channels they read.
Elsewhere every rank computes the whole block from gathered weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from ..kernels import ops
from ..distributed.collectives import copy_in, gather, raw_all_gather, reduce_out
from .common import ModelConfig, ParamSpec

__all__ = ["mamba_specs", "mamba_apply", "mamba_decode", "init_ssm_state",
           "mamba_head_parallel", "mamba_columns"]


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


def _local_dims(p: Dict[str, torch.Tensor]) -> Tuple[int, int, int]:
    """``(d_inner, heads, d_head)`` of the heads ``p`` holds (all, or a rank's)."""
    d_inner, n_heads = p["norm_z"].shape[0], p["a_log"].shape[0]
    return d_inner, n_heads, d_inner // n_heads


def _split_proj(cfg: ModelConfig, p, proj: torch.Tensor):
    """``(z, xbc, dt)`` of the input projection."""
    d_inner, n_heads, _ = _local_dims(p)
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


def init_ssm_state(cfg: ModelConfig, batch: int, device: torch.device,
                   parts: int = 1) -> Dict[str, torch.Tensor]:
    """The zero state; ``parts``: the ranks the heads are cut over (a rank's
    heads and the channels they read)."""
    d_inner, n_heads, d_head = _dims(cfg)
    return {
        "h": torch.zeros(batch, n_heads // parts, d_head, cfg.ssm_state, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, d_inner // parts + 2 * cfg.ssm_state,
                            device=device),
    }


_CUTS = {"w_in": (None, "model"), "conv_w": (None, "model"), "a_log": ("model",),
         "d_skip": ("model",), "dt_bias": ("model",), "norm_z": ("model",), "w_out": ("model",)}


def mamba_head_parallel(cfg: ModelConfig, specs: Dict[str, tuple], mesh) -> bool:
    """Whether the rank computes its own heads: ``model`` divides them and
    cuts every weight (see the module's doc)."""
    m = mesh.axis_size("model")
    return m > 1 and _dims(cfg)[1] % m == 0 and all(specs.get(k) == v for k, v in _CUTS.items())


def _columns(cfg: ModelConfig, mesh) -> Dict[str, torch.Tensor]:
    """The indices of the rank's columns of ``w_in`` and ``conv_w``: its
    heads' z, x and dt and all of B and C."""
    m, r = mesh.axis_size("model"), mesh.index("model")
    d_inner, n_heads, _ = _dims(cfg)
    ds, dl, hl = cfg.ssm_state, d_inner // m, n_heads // m
    mine, bc = torch.arange(r * dl, (r + 1) * dl), 2 * d_inner + torch.arange(2 * ds)
    dt = 2 * d_inner + 2 * ds + r * hl + torch.arange(hl)
    return {"w_in": torch.cat([mine, d_inner + mine, bc, dt]),
            "conv_w": torch.cat([mine, bc - d_inner])}


def mamba_columns(cfg: ModelConfig, p, mesh) -> Dict[str, torch.Tensor]:
    """``{"w_in", "conv_w"}``: the rank's columns (:func:`_columns`) of the
    weights gathered over ``model``, their gradient reduce-scattered over it."""
    return {k: gather(p[k], mesh, "model", 1, partial=True).index_select(1, c.to(p[k].device))
            for k, c in _columns(cfg, mesh).items()}


def _every_column(proj: torch.Tensor, conv_w: torch.Tensor, mesh):
    """``(projection, conv_w)`` with every column, from each rank's own
    columns of both: one all-gather over ``model``."""
    m, n = mesh.axis_size("model"), proj.numel()
    both = raw_all_gather(torch.cat([proj.reshape(-1), conv_w.reshape(-1).to(proj.dtype)])[None],
                          mesh, "model")  # [m, n + conv_w's]
    proj = both[:, :n].reshape(m, -1, proj.shape[-1]).transpose(0, 1).reshape(*proj.shape[:-1], -1)
    conv = both[:, n:].reshape(m, *conv_w.shape).transpose(0, 1).reshape(conv_w.shape[0], -1)
    return proj, conv.to(conv_w.dtype)


def _ssm_step(h, xt, bt, ct, dtt, a, d_skip):
    """One step of the recurrence, float32: ``(h, y_t)``.

    xt: [B, H, Dh]; bt / ct: [B, ds]; dtt: [B, H]; h: [B, H, Dh, ds].
    """
    decay = torch.exp(-a[None, :] * dtt)[..., None, None]
    upd = (dtt[..., None, None] * xt[..., :, None]) * bt[:, None, None, :]
    h = h * decay + upd
    return h, torch.einsum("bhds,bs->bhd", h, ct) + d_skip[None, :, None] * xt


def _ssm_scan(x, Bm, Cm, dt, a, d_skip):
    """x: [B, S, H, Dh]; Bm / Cm: [B, S, ds]; dt: [B, S, H] -> (y [B, S, H, Dh], h)."""
    B, S, n_heads, d_head = x.shape
    x, Bm, Cm, dt = x.float(), Bm.float(), Cm.float(), dt.float()
    h = torch.zeros(B, n_heads, d_head, Bm.shape[-1], device=x.device)
    ys = []
    for t in range(S):
        h, yt = _ssm_step(h, x[:, t], Bm[:, t], Cm[:, t], dt[:, t], a, d_skip)
        ys.append(yt)
    return torch.stack(ys, dim=1), h


def mamba_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], u: torch.Tensor, *,
                return_state: bool = False, mesh=None):
    """u: [B, S, d_model] -> y [B, S, d_model] (full forward / prefill);
    with ``return_state`` also the state after the last token.  With a bound
    ``mesh`` (the caller checked :func:`mamba_head_parallel`), ``p`` holds
    this rank's shards and the state is its heads' (see the module's doc)."""
    if mesh is not None:
        p = {**p, **mamba_columns(cfg, p, mesh)}
        out = mamba_apply(cfg, p, copy_in(u, mesh, "model"), return_state=return_state)
        if return_state:
            return reduce_out(out[0], mesh, "model"), out[1]
        return reduce_out(out, mesh, "model")
    B, S, _ = u.shape
    d_inner, n_heads, d_head = _local_dims(p)
    ds = cfg.ssm_state
    z, xbc_raw, dt_raw = _split_proj(cfg, p, u @ p["w_in"])
    xbc = _causal_conv(xbc_raw, p["conv_w"])
    x, Bm, Cm = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = torch.exp(p["a_log"].float())
    y, h = _ssm_scan(x.reshape(B, S, n_heads, d_head), Bm, Cm, dt, a, p["d_skip"].float())
    y = y.reshape(B, S, d_inner).to(u.dtype)
    out = (y * F.silu(z + p["norm_z"])) @ p["w_out"]
    if not return_state:
        return out
    K = cfg.ssm_conv
    conv_tail = F.pad(xbc_raw, (0, 0, K - 1, 0))[:, S:].float()  # the last K - 1 inputs
    return out, {"h": h, "conv": conv_tail}


def mamba_decode(cfg: ModelConfig, p: Dict[str, torch.Tensor], u: torch.Tensor,
                 state: Dict[str, torch.Tensor], *, mesh=None):
    """One token, u: [B, 1, d_model] -> ``(y [B, 1, d_model], state)``.

    ``state`` is updated in place: its ``h`` and ``conv`` entries are replaced
    by the new state, and the same dict is returned.  With a bound ``mesh``
    (the caller checked :func:`mamba_head_parallel`), ``p`` holds this rank's
    shards and ``state`` its heads' (see the module's doc).
    """
    if mesh is None:
        return _decode(cfg, p, u @ p["w_in"], state)
    proj, conv_w = _every_column(u @ p["w_in"], p["conv_w"], mesh)
    cols = {k: c.to(u.device) for k, c in _columns(cfg, mesh).items()}
    y, state = _decode(cfg, {**p, "conv_w": conv_w.index_select(1, cols["conv_w"])},
                       proj.index_select(-1, cols["w_in"]), state)
    return reduce_out(y, mesh, "model"), state


def _decode(cfg: ModelConfig, p, proj: torch.Tensor, state: Dict[str, torch.Tensor]):
    """:func:`mamba_decode` from the token's projection ``[B, 1, z | xBC | dt]``
    of the heads ``p`` holds: one call takes it to the gated ``y``, ``h``
    updated in place."""
    with tracing.span("mamba.update"):
        y, state["conv"] = ops.mamba_decode(proj, state["conv"], state["h"], p["conv_w"],
                                            p["dt_bias"], p["a_log"], p["d_skip"], p["norm_z"])
    return y @ p["w_out"], state
