"""Serving substrate of the port: batched prefill/decode engine."""

from .engine import ServeConfig, ServeEngine

__all__ = ["ServeConfig", "ServeEngine"]
