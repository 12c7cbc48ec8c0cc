"""Plain PyTorch versions of the ported kernels, under the reference's names.

Each lives beside its kernel's wrapper; this module gathers them as
``repro/kernels/ref.py`` does for the Pallas kernels.
"""

from .decode_attention import decode_attention_ref
from .gemv import gemv_ref
from .gemv_tiles import gemv_tiles_ref
from .rmsnorm import rmsnorm_ref

__all__ = ["decode_attention_ref", "gemv_ref", "gemv_tiles_ref", "rmsnorm_ref"]
