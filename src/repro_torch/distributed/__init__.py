"""Distribution substrate on ``torch.distributed`` (port of ``repro.distributed``):
sharding rules, collectives, ZeRO-1, remat policies and the GPipe pipeline.

``world.run_world`` spawns a local world to run them in; ``launch/mesh.py``
holds the meshes they take.
"""

from .collectives import (
    compressed_psum,
    fused_gemv_allreduce,
    overlap_grad_allreduce,
    psum_matmul,
    ring_allreduce,
)
from .pipeline import bubble_fraction, pipeline_apply, stack_stage_params
from .remat import POLICIES, get_policy, maybe_remat
from .sharding import (
    DEFAULT_RULES,
    ShardingRules,
    batch_spec,
    constrain,
    gather_params,
    param_shardings,
    resolve_spec,
    shard_params,
)
from .world import run_world
from .zero import zero1_from_params, zero1_shardings, zero1_spec

__all__ = [
    "psum_matmul",
    "fused_gemv_allreduce",
    "ring_allreduce",
    "compressed_psum",
    "overlap_grad_allreduce",
    "run_world",
    "DEFAULT_RULES", "ShardingRules", "constrain", "param_shardings",
    "resolve_spec", "batch_spec", "shard_params", "gather_params",
    "zero1_shardings", "zero1_spec", "zero1_from_params",
    "POLICIES", "get_policy", "maybe_remat",
    "bubble_fraction", "pipeline_apply", "stack_stage_params",
]
