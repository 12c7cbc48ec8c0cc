"""Deterministic synthetic data of the port (a copy of ``repro.data``)."""

from .pipeline import DataConfig, SyntheticLMDataset, prefetch

__all__ = ["DataConfig", "SyntheticLMDataset", "prefetch"]
