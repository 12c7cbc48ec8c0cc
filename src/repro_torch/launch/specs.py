"""Stand-ins for a dry-run cell's inputs and their placement (port of
``repro/launch/specs.py``).

``input_specs(model, shape)`` gives the cell's step inputs as ``meta``
tensors: shapes and dtypes, no data, no device memory (the reference's
``jax.ShapeDtypeStruct``s).  Train gets the global token and label batches
(the train step cuts each rank's rows itself), prefill the token batch, and
a config with a stub frontend (qwen2-vl, musicgen) the precomputed
embeddings its prefill takes.  Decode gets one token a row ``[B]``, the
position ``pos`` (a Python int, the last of the cell's S slots) and the
caches of S slots from ``Model.abstract_caches``: on a model bound to a
mesh, the rank's shards.  :func:`batch_spec` is the placement of a batch,
rows over ("pod", "data") where the mesh has them, and :func:`rank_rows` a
rank's rows under it (every row where those axes do not divide the batch,
as a served batch's rows are placed).

The caches' placement, the reference's ``_cache_leaf_spec`` and
``cache_shardings``, is ``distributed.sharding.cache_leaf_spec`` and
``models.model.cache_specs``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.shapes import ShapeSpec
from ..distributed.sharding import rows_spec, shard_tensor
from ..models import Model

__all__ = ["input_specs", "batch_spec", "rank_rows"]

META = torch.device("meta")


def _tok(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=META)


def input_specs(model: Model, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Stand-ins for one cell's step inputs (no device memory)."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    has_frontend = cfg.frontend != "none"
    if shape.mode == "train":
        return {"tokens": _tok(B, S), "labels": _tok(B, S)}
    if shape.mode == "prefill":
        out = {"tokens": _tok(B, S)}
        if has_frontend:
            # modality stub: precomputed frame/patch embeddings
            out["embeds"] = torch.empty((B, S, cfg.d_model), dtype=cfg.param_dtype, device=META)
        return out
    # decode: one new token against a cache of S resident slots
    out = {"tokens": _tok(B), "pos": S - 1, "caches": model.abstract_caches(B, S)}
    if has_frontend:
        out["embeds"] = torch.empty((B, 1, cfg.d_model), dtype=cfg.param_dtype, device=META)
    return out


def batch_spec(mesh) -> tuple:
    """The spec of a batch: its rows over the mesh's batch axes."""
    axes = mesh.batch_axes
    return (axes if len(axes) > 1 else axes[0] if axes else None,)


def rank_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a batch ``t`` placed as :func:`batch_spec` says;
    every row where the batch axes do not divide them (``rows_spec``)."""
    rows = rows_spec(mesh, t.shape[0])
    return t if rows is None else shard_tensor(t, (rows,), mesh)
