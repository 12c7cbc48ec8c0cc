"""PyTorch/CUDA port of the ``repro`` serving path (gemma3-1b decode).

The package mirrors ``repro``'s layout (``models/``, ``kernels/``,
``serving/``, ``launch/``, ``configs/``) so every module has one counterpart
to be held against, but it imports ``torch`` only: no ``jax`` and nothing of
``repro``.  Where it needs a piece of a reference module it keeps its own
copy.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the two Hopper kernels (``kernels/csrc/*.cu``) are built
with ``nvcc`` at first use on the card.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
