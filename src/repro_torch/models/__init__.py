"""Model zoo of the port: shared components and the attention-family decoder."""

from .common import ModelConfig, ParamSpec, count_params, materialize
from .model import Model

__all__ = ["ModelConfig", "ParamSpec", "count_params", "materialize", "Model"]
