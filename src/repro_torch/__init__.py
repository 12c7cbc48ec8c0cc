"""PyTorch/CUDA port of ``repro``: serving of the attention families and the
fused GEMV+AllReduce.

The package mirrors ``repro``'s layout so every module has one counterpart
to be held against: ``models/``, ``serving/``, ``launch/`` and ``configs/``
(forward, prefill and decode of the dense, sliding, MLA, M-RoPE and MoE
configs), ``kernels/`` (the four Hopper kernels and their plain
versions), ``distributed/`` (the fused GEMV+AllReduce and its companion
collectives on ``torch.distributed``) and ``core/`` (the Eidola model's two
spin-wait scans).  It imports ``torch`` only: no ``jax`` and nothing of
``repro``.  Where it needs a piece of a reference module it keeps its own
copy.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the kernels (``kernels/csrc/*.cu``) are built with
``nvcc`` at first use on the card.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
