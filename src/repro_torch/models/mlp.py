"""Gated MLP (SwiGLU / GeGLU) used by every dense block (port of ``repro.models.mlp``).

Under a bound mesh (a sharded model) the hidden width is the rank's where
the ``mlp`` rule cuts it over ``model``: ``w_gate`` and ``w_up``
column-parallel, ``w_down`` row-parallel, the input's gradient summed over
``model`` and the output summed.  Otherwise every rank computes the whole
MLP from gathered weights.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..distributed.collectives import copy_in, reduce_out
from ..distributed.sharding import use_params
from .common import ModelConfig, ParamSpec

__all__ = ["mlp_specs", "mlp_apply", "activation", "col_parallel"]


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


def mlp_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
              mesh=None, specs: Dict[str, tuple] | None = None) -> torch.Tensor:
    """The gated MLP; with a bound ``mesh``, ``p`` holds this rank's shards,
    cut as ``specs`` says (see the module's doc)."""
    if mesh is not None:
        specs = specs or {}
        if mesh.axis_size("model") > 1 and col_parallel(specs):
            return reduce_out(mlp_apply(cfg, p, copy_in(x, mesh, "model")), mesh, "model")
        p = use_params(p, specs, mesh)
    g = activation(cfg)(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


def col_parallel(specs: Dict[str, tuple]) -> bool:
    """Whether the specs cut the hidden width over ``model`` (and nothing else)."""
    return (specs.get("w_gate") == specs.get("w_up") == (None, "model")
            and specs.get("w_down") == ("model",))
