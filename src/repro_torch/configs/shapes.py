"""Assigned input shapes and (arch x shape) cell enumeration (port of
``repro/configs/shapes.py``, a copy).

Four shapes per LM architecture.  ``decode_*`` / ``long_*`` are serve steps
(one new token against a KV cache of seq_len), not train steps;
``long_500k`` needs sub-quadratic context handling and is skipped for pure
full-attention archs.  The port's dry run traces every cell
(``launch/dryrun.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = ["ShapeSpec", "SHAPES", "cells_for", "all_cells"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cells_for(cfg) -> List[Tuple[str, Optional[str]]]:
    """(shape_name, skip_reason|None) for one architecture config."""
    out: List[Tuple[str, Optional[str]]] = []
    for name, spec in SHAPES.items():
        if name == "long_500k" and not cfg.supports_500k:
            out.append((name, "pure full attention: quadratic-context arch, "
                              "skipped per assignment (DESIGN.md)"))
        else:
            out.append((name, None))
    return out


def all_cells(registry) -> List[Tuple[str, str, Optional[str]]]:
    """(arch, shape, skip_reason) across the whole pool."""
    cells = []
    for arch_id, cfg_fn in registry.items():
        cfg = cfg_fn()
        for shape, skip in cells_for(cfg):
            cells.append((arch_id, shape, skip))
    return cells
