"""Architecture registry of the port: ``--arch <id>`` resolves here.

The port serves the dense gemma3-1b only; the other architectures of the
reference's registry join as their blocks are ported.  ``reduced()`` is a
copy of the reference's family-preserving reduction for CPU tests.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..models.common import ModelConfig
from . import gemma3_1b

REGISTRY: Dict[str, Callable[[], ModelConfig]] = {
    "gemma3-1b": gemma3_1b.config,
}

META = {
    "gemma3-1b": gemma3_1b.META,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(REGISTRY)}")
    return REGISTRY[arch]()


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduction for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=256,
        head_dim=16,
        max_seq_len=256,
    )
    if cfg.attn_kind == "mla":
        kw.update(mla_kv_rank=32, mla_q_rank=48 if cfg.mla_q_rank else 0,
                  mla_rope_dim=8)
    if cfg.attn_kind == "sliding":
        kw.update(sliding_window=16, global_every=min(cfg.global_every, 2))
    if cfg.rope_kind == "mrope":
        kw.update(mrope_sections=(2, 3, 3))  # sums to reduced head_dim // 2
    if cfg.n_experts:
        kw.update(n_experts=8, experts_per_token=2,
                  first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.family == "hybrid":
        kw.update(attn_block_every=2, ssm_state=16)
    if cfg.family == "ssm" and cfg.xlstm_pattern:
        kw.update(xlstm_pattern=cfg.xlstm_pattern[:4] or "msms")
    if cfg.frontend != "none":
        kw.update(frontend_dim=64)
    return cfg.with_(**kw)


__all__ = ["REGISTRY", "META", "get_config", "reduced"]
