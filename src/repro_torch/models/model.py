"""Model assembly for serving (port of ``repro.models.model``, dense plan only).

The reference stacks a scan stage's parameters on a leading ``layers`` dim;
the port keeps one :class:`DenseBlock` per layer in an ``nn.ModuleList``
(``models/convert.py`` unstacks the reference's tree).  Serving walks the
layers in a Python loop, as the reference's ``decode_step`` does, with a
full-length KV cache on global layers and a ring buffer on local ones.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .attention import attention_decode, attention_specs, init_kv_cache
from .common import ModelConfig, ParamSpec, count_params, materialize, rms_norm
from .mlp import mlp_apply, mlp_specs

__all__ = ["DenseBlock", "Model", "param_specs"]


def _block_specs(cfg: ModelConfig) -> Dict[str, ParamSpec | Dict[str, ParamSpec]]:
    d, pd = cfg.d_model, cfg.param_dtype
    return {
        "ln1": ParamSpec((d,), ("embed",), pd, init="zeros"),
        "attn": attention_specs(cfg),
        "ln2": ParamSpec((d,), ("embed",), pd, init="zeros"),
        "mlp": mlp_specs(cfg),
    }


def param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """``{state_dict name: ParamSpec}`` of :class:`Model`, in registration order."""
    if cfg.family != "dense" or cfg.n_experts or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: only the dense plan is ported (family={cfg.family!r})"
        )
    specs = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           cfg.param_dtype, init="embed", scale=0.02),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), cfg.param_dtype,
                                init="zeros"),
    }
    for li in range(cfg.n_layers):
        for name, s in _block_specs(cfg).items():
            if isinstance(s, ParamSpec):
                specs[f"blocks.{li}.{name}"] = s
            else:
                specs.update({f"blocks.{li}.{name}.{k}": v for k, v in s.items()})
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                                     cfg.param_dtype, scale=0.02)
    return specs


def _param(spec: ParamSpec, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(spec.shape, dtype=spec.dtype, device=device),
                        requires_grad=False)


class DenseBlock(nn.Module):
    """Pre-norm attention + gated MLP, both residual."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        specs = _block_specs(cfg)
        self.ln1 = _param(specs["ln1"], device)
        self.attn = nn.ParameterDict({k: _param(s, device) for k, s in specs["attn"].items()})
        self.ln2 = _param(specs["ln2"], device)
        self.mlp = nn.ParameterDict({k: _param(s, device) for k, s in specs["mlp"].items()})

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int):
        cfg = self.cfg
        a, cache = attention_decode(cfg, self.attn, rms_norm(x, self.ln1, cfg.norm_eps),
                                    cache, pos)
        x = x + a
        return x + mlp_apply(cfg, self.mlp, rms_norm(x, self.ln2, cfg.norm_eps)), cache


class Model(nn.Module):
    """Dense decoder for serving; parameters live on ``device`` (the card by default).

    The constructor allocates zeroed parameters; :meth:`init` draws them from
    a seeded ``torch.Generator`` and ``load_state_dict`` loads given ones
    (``models.convert.params_from_jax`` carries the reference's across).
    """

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        specs = param_specs(cfg)
        self.embed = _param(specs["embed"], self.device)
        self.final_norm = _param(specs["final_norm"], self.device)
        self.blocks = nn.ModuleList(DenseBlock(cfg, self.device) for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = _param(specs["lm_head"], self.device)

    # -- parameters -----------------------------------------------------------

    def param_specs(self) -> Dict[str, ParamSpec]:
        return param_specs(self.cfg)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (seeded by the caller)."""
        own = dict(self.named_parameters())
        for name, value in materialize(self.param_specs(), generator, self.device).items():
            own[name].copy_(value)
        return self

    def n_params(self) -> int:
        return count_params(self.param_specs())

    # -- embedding / head -------------------------------------------------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.scale_embed:
            # sqrt(d_model) rounded to the activation dtype first, as in the
            # reference: 33.94 becomes 34.0 in bf16
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype, device=x.device)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = (x @ w).float()  # product in the param dtype, then float32
        if cfg.logit_softcap > 0:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    # -- serving ----------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int):
        return [init_kv_cache(self.cfg, batch, max_len, li, self.device)
                for li in range(self.cfg.n_layers)]

    @torch.no_grad()
    def decode_step(
        self, caches: List[Dict[str, torch.Tensor]], tokens: torch.Tensor, pos: int
    ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """One token for every sequence in the batch.

        tokens: int[B]; pos: tokens already in the cache.  The caches are
        written in place.  Returns (logits [B, V] float32, caches).
        """
        tokens = torch.as_tensor(tokens, device=self.device)
        x = self._embed(tokens[:, None])
        for block, cache in zip(self.blocks, caches):
            x, _ = block.decode(x, cache, pos)
        return self._head(x)[:, 0, :], caches
