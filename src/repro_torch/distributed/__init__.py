"""Collectives on ``torch.distributed`` process groups (port of ``repro.distributed``).

Only the collectives of the fused GEMV+AllReduce path are ported so far;
``world.run_world`` spawns a local gloo world to run them in.
"""

from .collectives import (
    compressed_psum,
    fused_gemv_allreduce,
    overlap_grad_allreduce,
    psum_matmul,
    ring_allreduce,
)
from .world import run_world

__all__ = [
    "psum_matmul",
    "fused_gemv_allreduce",
    "ring_allreduce",
    "compressed_psum",
    "overlap_grad_allreduce",
    "run_world",
]
