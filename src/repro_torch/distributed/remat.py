"""Activation-checkpoint (remat) policies (port of ``repro/distributed/remat.py``).

The reference names ``jax.checkpoint_policies``; here a policy decides, op
by op, what ``torch.utils.checkpoint`` keeps from the forward
(``create_selective_checkpoint_contexts``): everything else is recomputed
in the backward.

- "full": nothing is kept (the reference's ``nothing_saveable``).
- "dots": every matrix product's output is kept (``dots_saveable``): ``mm``,
  ``addmm``, ``bmm``, ``baddbmm`` and the MoE's ``_grouped_mm``.
- "dots_no_batch": only the products without batch dims
  (``dots_with_no_batch_dims_saveable``): ``mm`` and ``addmm``, which a
  projection ``x @ w`` becomes; attention's per-head ``bmm`` is recomputed.
- "none": no remat.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["POLICIES", "get_policy", "maybe_remat"]

_aten = torch.ops.aten
_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
_BATCH = frozenset({_aten.bmm.default, _aten.baddbmm.default}
                   | ({_aten._grouped_mm.default} if hasattr(_aten, "_grouped_mm") else set()))

# each policy's matrix products kept from the forward; None: no remat
POLICIES: Dict[str, Optional[frozenset]] = {
    # recompute everything in backward (min memory, max recompute)
    "full": frozenset(),
    # save matmul outputs (the usual sweet spot for transformer blocks)
    "dots": _NO_BATCH | _BATCH,
    "dots_no_batch": _NO_BATCH,
    # no remat at all (max memory, zero recompute)
    "none": None,
}


def get_policy(name: str):
    """The named policy: ``policy(ctx, op, *args, **kwargs) -> CheckpointPolicy``,
    None for "none"."""
    if name not in POLICIES:
        raise KeyError(f"unknown remat policy {name!r}; one of {sorted(POLICIES)}")
    keep = POLICIES[name]
    if keep is None:
        return None

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in keep else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def maybe_remat(f: Callable, policy_name: str) -> Callable:
    """``f`` under ``torch.utils.checkpoint`` with the named policy ('none':
    ``f`` itself).  "full" keeps nothing, so it needs no policy on each op
    and runs as plain ``checkpoint``: the selective contexts watch every op
    from Python, which costs host time a launch."""
    if get_policy(policy_name) is None:
        return f
    kwargs = {} if not POLICIES[policy_name] else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, get_policy(policy_name))}

    def run(*args):
        return checkpoint(f, *args, use_reentrant=False, **kwargs)
    return run
