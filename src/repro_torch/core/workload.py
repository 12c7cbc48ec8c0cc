"""Fused GEMV+AllReduce workload model (paper Fig. 3) and trace generation (port of
``repro/core/workload.py``).

The GEMV ``y = A @ x`` (A: M x K) is partitioned column-parallel: device ``d``
owns the K-slice ``[d*K/n, (d+1)*K/n)`` and computes a *partial* for every
output row; output rows are partitioned by *owner* (device ``r`` owns rows
``[r*M/n, (r+1)*M/n)``) so each device reduces its own rows after receiving
peer partials.  That is exactly the structure of the fused kernel's phases:

  remote_tiles : partials for rows owned by peers  -> xGMI-written to owners
  flag_write   : flags[my_gpu] <- 1 on every peer
  local_tiles  : partials for rows owned locally   -> local writes
  wait_flags   : spin/monitor until every peer's flag is set locally
  reduce       : sum the n partials for each owned row
  broadcast    : push final rows to all peers

The *detailed* device is always device 0; devices 1..n-1 are eidolons whose
only simulated effect is the registered writes they replay (partials + flags).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .config import SimConfig
from .events import TraceBundle
from .memory import AddressMap

__all__ = ["WGPlan", "GemvAllReduceWorkload", "make_gemv_allreduce_traces"]


@dataclass(frozen=True)
class WGPlan:
    """Static per-workgroup execution plan (durations in cycles)."""

    wg: int
    cu: int
    dispatch_cycle: int
    n_remote_rows: int
    n_local_rows: int
    remote_cycles: int
    flag_write_cycles: int
    local_cycles: int
    reduce_cycles: int
    broadcast_cycles: int
    # traffic attributable to this WG's closed-form phases
    remote_sector_reads: int
    local_sector_reads: int
    remote_xgmi_writes: int   # partial-tile pushes to peers
    local_partial_writes: int
    reduce_reads: int         # peer-partial reads during reduction
    broadcast_xgmi_writes: int
    broadcast_local_writes: int


class GemvAllReduceWorkload:
    """Builds per-WG plans + peer traces for the fused GEMV+AllReduce kernel."""

    def __init__(self, cfg: SimConfig, amap: Optional[AddressMap] = None):
        cfg.validate()
        self.cfg = cfg
        self.amap = amap or AddressMap(n_devices=cfg.n_devices)
        self.plans: List[WGPlan] = self._build_plans()

    # ------------------------------------------------------------------
    # row -> workgroup assignment
    # ------------------------------------------------------------------

    def _row_counts(self) -> Tuple[List[int], List[int]]:
        """Per-WG counts of (remote, local) rows, round-robin assigned."""
        cfg = self.cfg
        n_remote = cfg.M - cfg.rows_per_device
        n_local = cfg.rows_per_device
        remote = [0] * cfg.workgroups
        local = [0] * cfg.workgroups
        for i in range(n_remote):
            remote[i % cfg.workgroups] += 1
        for i in range(n_local):
            local[i % cfg.workgroups] += 1
        return remote, local

    def _build_plans(self) -> List[WGPlan]:
        cfg = self.cfg
        remote_rows, local_rows = self._row_counts()
        n_peers = cfg.n_egpus
        plans: List[WGPlan] = []
        for wg in range(cfg.workgroups):
            cu = wg % cfg.n_cus
            wave = wg // cfg.n_cus
            rr, lr = remote_rows[wg], local_rows[wg]
            plans.append(
                WGPlan(
                    wg=wg,
                    cu=cu,
                    dispatch_cycle=wave * cfg.dispatch_stagger_cycles,
                    n_remote_rows=rr,
                    n_local_rows=lr,
                    remote_cycles=rr * cfg.row_cycles,
                    flag_write_cycles=n_peers * cfg.flag_write_cycles,
                    local_cycles=lr * cfg.row_cycles,
                    reduce_cycles=lr * cfg.reduce_cycles_per_row,
                    broadcast_cycles=lr * cfg.broadcast_cycles_per_row,
                    remote_sector_reads=rr * cfg.sectors_per_row,
                    local_sector_reads=lr * cfg.sectors_per_row,
                    remote_xgmi_writes=rr,  # one partial push per remote row
                    local_partial_writes=lr,
                    # reduce reads the n_devices partials of each owned row;
                    # partials for one row fit in <= one sector each read burst
                    reduce_reads=lr * cfg.n_devices,
                    broadcast_xgmi_writes=lr * n_peers,
                    broadcast_local_writes=lr,
                )
            )
        return plans

    # ------------------------------------------------------------------
    # aggregate expectations (used by tests and the vector engine)
    # ------------------------------------------------------------------

    def expected_nonflag_reads(self) -> int:
        """Closed-form non-flag read count (matrix sectors + reduce reads).

        With Table-1 parameters this evaluates to 65,536 matrix sector reads
        + 256 reduce reads = 65,792 ~ the paper's "approximately 66K".
        """
        cfg = self.cfg
        matrix = cfg.M * cfg.sectors_per_row
        reduce = cfg.rows_per_device * cfg.n_devices
        return matrix + reduce

    def flag_order(self) -> List[int]:
        """Peer polling order (paper Fig. 3 line 14: ascending rgpu)."""
        return list(range(1, self.cfg.n_devices))

    # ------------------------------------------------------------------
    # eidolon trace generation
    # ------------------------------------------------------------------

    def make_traces(
        self,
        flag_delays_ns: Sequence[float] | float,
    ) -> TraceBundle:
        return make_gemv_allreduce_traces(self.cfg, flag_delays_ns, self.amap)


def make_gemv_allreduce_traces(
    cfg: SimConfig,
    flag_delays_ns: Sequence[float] | float,
    amap: Optional[AddressMap] = None,
) -> TraceBundle:
    """Registered-write trace for the eidolons of a fused GEMV+AllReduce launch.

    ``flag_delays_ns`` gives, per eidolon, the wakeupTime of its flag write
    relative to main-kernel launch (the paper's swept parameter).  A scalar
    applies the same delay to every eidolon.  When
    ``cfg.include_data_writes`` each eidolon also pushes its partial tiles for
    the target-owned rows shortly before its flag (the kernel writes data, then
    the flag) — those land in the partial region and are counted as incoming
    xGMI traffic but never as flag traffic.
    """
    amap = amap or AddressMap(n_devices=cfg.n_devices)
    if isinstance(flag_delays_ns, (int, float)):
        delays = [float(flag_delays_ns)] * cfg.n_egpus
    else:
        delays = [float(d) for d in flag_delays_ns]
        if len(delays) != cfg.n_egpus:
            raise ValueError(
                f"need {cfg.n_egpus} delays, got {len(delays)}"
            )

    bundle = TraceBundle(
        meta={
            "workload": "fused_gemv_allreduce",
            "M": cfg.M,
            "K": cfg.K,
            "N": cfg.N,
            "n_devices": cfg.n_devices,
            "flag_delays_ns": delays,
        }
    )
    rows_for_target = cfg.rows_per_device
    for g in range(1, cfg.n_devices):
        delay = delays[g - 1]
        if cfg.include_data_writes:
            # Partial tiles for the target's owned rows: one write per row.
            # They are spread across a short window ending data_write_lead_ns
            # before the flag (clamped at 0) — data must precede the flag.
            lead = cfg.data_write_lead_ns
            t0 = max(0.0, delay - lead)
            span = max(1.0, lead * 0.5)
            for r in range(rows_for_target):
                t = min(t0 + span * (r + 1) / rows_for_target, max(0.0, delay))
                bundle.add(
                    wakeup_ns=t,
                    addr=amap.partial_base
                    + (g * rows_for_target + r) * cfg.elem_bytes * cfg.N,
                    data=0xA0 + g,
                    size=min(8, cfg.elem_bytes * cfg.N),
                    src=g,
                )
        bundle.add(
            wakeup_ns=delay,
            addr=amap.flag_addr(g),
            data=1,
            size=8,
            src=g,
        )
    return bundle
