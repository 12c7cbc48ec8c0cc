"""Optimizer of the port: AdamW with float32 master weights (port of ``repro.optim``)."""

from .adamw import AdamWConfig, adamw_init, adamw_step, cosine_lr, global_norm

__all__ = ["AdamWConfig", "adamw_init", "adamw_step", "cosine_lr", "global_norm"]
