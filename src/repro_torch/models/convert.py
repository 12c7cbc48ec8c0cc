"""Carry the reference's parameters into the port.

The reference keeps a scan stage's parameters stacked on a leading ``layers``
dim (``{"embed", "final_norm", "stages": [{"ln1": [L, d], "attn": {...},
...}]}``); the port keeps one block per layer.  :func:`params_from_jax`
takes that tree with numpy leaves (bf16 leaves as ``ml_dtypes.bfloat16``
arrays, as ``np.asarray`` gives them) and returns a ``state_dict`` for
``Model(cfg)``.  No JAX is imported: the caller converts to numpy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .common import ModelConfig
from .model import param_specs

__all__ = ["params_from_jax"]


def _to_torch(a: Any) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """``state_dict`` of ``Model(cfg)`` from the reference's numpy parameter tree."""
    if len(np_tree["stages"]) != 1:
        raise ValueError(f"expected one dense scan stage, got {len(np_tree['stages'])}")
    stage = np_tree["stages"][0]
    flat: Dict[str, Any] = {"embed": np_tree["embed"], "final_norm": np_tree["final_norm"]}
    for li in range(cfg.n_layers):
        for name, leaf in stage.items():
            if isinstance(leaf, dict):
                flat.update({f"blocks.{li}.{name}.{k}": v[li] for k, v in leaf.items()})
            else:
                flat[f"blocks.{li}.{name}"] = leaf[li]
    if "lm_head" in np_tree:
        flat["lm_head"] = np_tree["lm_head"]

    specs = param_specs(cfg)
    if set(flat) != set(specs):
        raise ValueError(f"parameter names differ: missing {sorted(set(specs) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(specs))}")
    out = {}
    for name, spec in specs.items():
        t = _to_torch(flat[name])
        if tuple(t.shape) != spec.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {spec.shape}")
        out[name] = t.to(spec.dtype)
    return out
