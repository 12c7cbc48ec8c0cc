"""Roofline terms and step-time prediction from dry-run records (port of
``repro/core/predictor.py``).

A copy of the reference's three-term roofline over one rank's step::

  compute_s    = FLOPs      / peak_FLOP/s
  memory_s     = bytes      / HBM_bw
  collective_s = coll_bytes / link_bw

and its step-time envelope, whose collective time is the ring algebra of
each captured op.  An op that names its mesh axes is priced on them
(``core/capture.py::op_cost``); one that does not keeps the reference's
rule, the first axis whose size equals the group's.  The hardware is the
topology's (``H100_SXM`` or ``V5E``, ``core/interconnect.py``).  The
record's FLOPs and bytes are the port's counts of the eager step
(``core/cost.py``), where the reference's are XLA's.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional, Sequence

from .capture import CollectiveOp, collective_bytes, op_cost
from .topology import Topology

__all__ = ["RooflineTerms", "roofline", "StepPrediction", "predict_step"]


@dataclass(frozen=True)
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    useful_flops_ratio: float     # MODEL_FLOPS / (FLOPs * chips)
    bytes_per_device_hbm: int     # argument and peak live bytes
    fits_hbm: bool
    note: str = ""

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """Fraction of the step bound spent on useful model FLOPs."""
        if self.bound_s <= 0:
            return 0.0
        useful_s = self.compute_s * self.useful_flops_ratio
        return useful_s / self.bound_s

    def as_dict(self) -> Dict:
        d = asdict(self)
        d["bound_s"] = self.bound_s
        d["roofline_fraction"] = self.roofline_fraction()
        return d


def roofline(
    *,
    arch: str,
    shape: str,
    mesh: str,
    topo: Topology,
    hlo_flops_per_device: float,
    hlo_bytes_per_device: float,
    collective_ops: Sequence[CollectiveOp] = (),
    collective_bytes_per_device: Optional[int] = None,
    model_flops_total: float = 0.0,
    bytes_per_device_hbm: int = 0,
    collective_axis: Optional[str] = None,
    note: str = "",
) -> RooflineTerms:
    hw = topo.hw
    coll_bytes = (
        collective_bytes_per_device
        if collective_bytes_per_device is not None
        else collective_bytes(collective_ops)
    )
    compute_s = hlo_flops_per_device / hw.peak_flops_bf16
    memory_s = hlo_bytes_per_device / hw.hbm_bw
    collective_s = topo.flat_collective_seconds(coll_bytes, collective_axis)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)  # type: ignore[arg-type]
    chips = topo.n_chips
    hlo_total = hlo_flops_per_device * chips
    useful = model_flops_total / hlo_total if hlo_total > 0 else 0.0
    return RooflineTerms(
        arch=arch,
        shape=shape,
        mesh=mesh,
        chips=chips,
        hlo_flops_per_device=hlo_flops_per_device,
        hlo_bytes_per_device=hlo_bytes_per_device,
        collective_bytes_per_device=coll_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops_total=model_flops_total,
        useful_flops_ratio=useful,
        bytes_per_device_hbm=bytes_per_device_hbm,
        fits_hbm=bytes_per_device_hbm <= hw.hbm_bytes,
        note=note,
    )


@dataclass(frozen=True)
class StepPrediction:
    """Step-time envelope with and without compute/comm overlap."""

    no_overlap_s: float        # compute-or-memory bound + all collectives
    full_overlap_s: float      # max(compute, memory, collective)
    eidola_collective_s: float # topology-aware (ring algebra) collective time
    exposed_comm_s: float      # collective time not hideable under compute

    def as_dict(self) -> Dict:
        return asdict(self)


def predict_step(
    terms: RooflineTerms,
    topo: Topology,
    collective_ops: Sequence[CollectiveOp] = (),
    *,
    overlap_fraction: float = 0.0,
) -> StepPrediction:
    """Refine the flat collective term with ring algebra + overlap model.

    ``overlap_fraction`` is how much of collective time the schedule hides
    under compute (0 = paper-faithful sequential baseline).
    """
    eidola_coll = 0.0
    for op in collective_ops:
        if op.group_size == 1:
            continue
        eidola_coll += op_cost(op, topo).time_s
    base = max(terms.compute_s, terms.memory_s)
    exposed = max(0.0, eidola_coll * (1.0 - overlap_fraction))
    return StepPrediction(
        no_overlap_s=base + eidola_coll,
        full_overlap_s=max(base, eidola_coll),
        eidola_collective_s=eidola_coll,
        exposed_comm_s=exposed,
    )
