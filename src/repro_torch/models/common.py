"""Shared model-definition machinery (port of ``repro.models.common``).

A model is described by a :class:`ModelConfig`; its parameters are declared
as :class:`ParamSpec`s (shape, dtype, logical axes, initializer) keyed by the
port's ``state_dict`` names and materialized from a caller-seeded
``torch.Generator``.  The logical axes are kept so each spec reads like its
counterpart; nothing in the port shards on them yet.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops

__all__ = [
    "ModelConfig",
    "ParamSpec",
    "materialize",
    "fill_",
    "count_params",
    "rms_norm",
    "DEFAULT_PARAM_DTYPE",
]

DEFAULT_PARAM_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Superset config; every field of the reference's, with torch dtypes."""

    name: str = "model"
    family: str = "dense"          # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_ff: int = 256
    vocab: int = 1024
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    max_seq_len: int = 8192
    rope_theta: float = 10_000.0

    # attention structure
    attn_kind: str = "full"        # full | sliding | mla
    sliding_window: int = 1024
    global_every: int = 0          # e.g. 6 => layers 5, 11, ... are global
    rope_kind: str = "rope"        # rope | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # MLA (minicpm3 / kimi-k2)
    mla_kv_rank: int = 256
    mla_q_rank: int = 0            # 0 => no q compression
    mla_rope_dim: int = 32

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1             # every k-th layer is MoE (1 = all)
    first_dense_layers: int = 0    # leading dense layers (kimi-k2 style)
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_block_every: int = 0      # zamba2: shared attn block cadence

    # xLSTM
    xlstm_pattern: str = ""        # e.g. "msms..." per layer; empty = n/a

    # frontends (vlm / audio): backbone consumes precomputed embeddings
    frontend: str = "none"         # none | vision_stub | audio_stub
    frontend_dim: int = 0          # embedding dim delivered by the stub

    # numerics
    scale_embed: bool = False      # gemma-style sqrt(d) embedding scaling
    mlp_act: str = "silu"          # silu | gelu
    param_dtype: torch.dtype = DEFAULT_PARAM_DTYPE
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # long-context policy
    supports_500k: bool = False

    # perf options of the reference (sharding anchors, absorbed MLA); kept
    # so the configs compare field for field
    attn_sharding_constraints: bool = False
    mla_absorbed_decode: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def layer_kind(self, i: int) -> str:
        """What block sits at depth i (resolves hybrid/moe/sliding patterns)."""
        if self.family == "ssm" and self.xlstm_pattern:
            return "xlstm_" + self.xlstm_pattern[i % len(self.xlstm_pattern)]
        if self.family == "hybrid":
            return "mamba"
        if self.n_experts > 0:
            if i < self.first_dense_layers or (i % self.moe_every) != (
                self.moe_every - 1
            ):
                # note: with moe_every=1 every layer is MoE after the leading
                # dense layers
                if self.moe_every == 1 and i >= self.first_dense_layers:
                    return "moe"
                return "dense"
            return "moe"
        return "dense"

    def is_global_attn(self, i: int) -> bool:
        if self.attn_kind != "sliding" or self.global_every <= 0:
            return True
        return (i % self.global_every) == (self.global_every - 1)

    def validate(self) -> "ModelConfig":
        if self.n_heads % max(1, self.n_kv_heads) != 0:
            raise ValueError(
                f"n_heads {self.n_heads} is not a multiple of n_kv_heads "
                f"{self.n_kv_heads}"
            )
        if self.n_experts and not 0 < self.experts_per_token <= self.n_experts:
            raise ValueError(
                f"experts_per_token {self.experts_per_token} is not in "
                f"[1, n_experts = {self.n_experts}]"
            )
        return self

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = DEFAULT_PARAM_DTYPE
    init: str = "normal"     # normal | zeros | ones | embed
    scale: Optional[float] = None  # None => 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def fill_(dst: torch.Tensor, s: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    """Fill ``dst`` in place as ``s`` says, drawing from ``generator``.

    Normal draws are made in float32 on the generator's device and cast, as
    the reference draws float32 and casts.  A stacked expert tensor (3-D) is
    drawn one expert at a time, so the float32 draw never holds more than one
    expert: kimi-k2's ``[384, 7168, 2048]`` at once would take 22.5 GB.
    """
    if s.init == "zeros":
        return dst.zero_()
    if s.init == "ones":
        return dst.fill_(1)
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    scale = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
    if s.init == "embed":
        scale = s.scale if s.scale is not None else 1.0
    for part in (dst if dst.dim() >= 3 else [dst]):
        v = torch.randn(part.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        part.copy_(v * scale)
    return dst


def materialize(
    specs: Dict[str, ParamSpec],
    generator: torch.Generator,
    device: torch.device,
) -> Dict[str, torch.Tensor]:
    """Real tensors for a ``{name: ParamSpec}`` dict, drawn in name order.

    The stream is torch's, not JAX's threefry: the tests carry the
    reference's weights across instead.
    """
    return {name: fill_(torch.empty(s.shape, dtype=s.dtype, device=device), s, generator)
            for name, s in specs.items()}


def count_params(specs: Dict[str, ParamSpec]) -> int:
    return sum(math.prod(s.shape) for s in specs.values())


# ---------------------------------------------------------------------------
# numerics helpers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + gamma)`` in float32, stored in x's dtype.

    A CUDA tensor goes through the hand-written kernel, a CPU tensor through
    its plain version (``kernels.ops`` dispatches).
    """
    return ops.rmsnorm(x, gamma, eps)
