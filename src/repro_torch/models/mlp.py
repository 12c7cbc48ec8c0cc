"""Gated MLP (SwiGLU / GeGLU) used by every dense block (port of ``repro.models.mlp``)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import ModelConfig, ParamSpec

__all__ = ["mlp_specs", "mlp_apply", "activation"]


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> Dict[str, ParamSpec]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    pd = cfg.param_dtype
    return {
        "w_gate": ParamSpec((d, ff), ("embed", "mlp"), pd),
        "w_up": ParamSpec((d, ff), ("embed", "mlp"), pd),
        "w_down": ParamSpec((ff, d), ("mlp", "embed"), pd),
    }


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; F.gelu's default is erf
    return F.gelu(x, approximate="tanh")


def activation(cfg: ModelConfig):
    """The gate's activation: GELU (tanh form) or SiLU."""
    return _gelu_tanh if cfg.mlp_act == "gelu" else F.silu


def mlp_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    g = activation(cfg)(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]
