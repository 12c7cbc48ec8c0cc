"""The fused GEMV+AllReduce kernel (paper Fig. 3) as a registered scenario
(port of ``repro/core/scenarios/gemv_allreduce.py``).

The kernel as a phase program:

  remote_tiles : partials for rows owned by peers  -> xGMI-written to owners
  flag_write   : flags[my_gpu] <- 1 on every peer
  local_tiles  : partials for rows owned locally   -> local writes
  wait_flags   : spin/monitor until every peer's flag is set locally
  reduce       : sum the n partials for each owned row
  broadcast    : push final rows to all peers

Durations, traffic attribution, and trace generation all come from
:class:`repro_torch.core.workload.GemvAllReduceWorkload`, so the scenario
gives the reference's Table-1 numbers bit for bit (held in
``tests/test_torch_eidola.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from ..config import SimConfig
from ..events import TraceBundle
from ..memory import AddressMap
from ..scenario import (
    PhaseSpec,
    Scenario,
    WGProgram,
    local_writes,
    reads,
    register_scenario,
    xgmi_out,
)
from ..workload import GemvAllReduceWorkload, WGPlan, make_gemv_allreduce_traces

__all__ = ["GemvAllReduceScenario"]


@register_scenario
class GemvAllReduceScenario(Scenario):
    """Fused GEMV+AllReduce kernel (paper Table 1 / Fig. 3)."""

    name = "gemv_allreduce"

    def __init__(
        self,
        cfg: SimConfig,
        amap: Optional[AddressMap] = None,
        *,
        flag_delays_ns: Union[Sequence[float], float] = 10_000.0,
    ):
        super().__init__(cfg, amap)
        self.workload = GemvAllReduceWorkload(cfg, self.amap)
        self.flag_delays_ns = flag_delays_ns
        self.params = {"flag_delays_ns": flag_delays_ns}

    # ------------------------------------------------------------------

    def _program(self, p: WGPlan) -> WGProgram:
        cfg = self.cfg
        n_peers = cfg.n_egpus
        data_bytes = cfg.elem_bytes * cfg.N
        wait_addrs = tuple(self.amap.flag_addr(g) for g in self.workload.flag_order())
        return WGProgram(
            wg=p.wg,
            cu=p.cu,
            dispatch_cycle=p.dispatch_cycle,
            phases=(
                PhaseSpec(
                    "remote_tiles",
                    p.remote_cycles,
                    traffic=(
                        reads(p.remote_sector_reads, cfg.sector_bytes),
                        xgmi_out(p.remote_xgmi_writes, data_bytes),
                    ),
                ),
                PhaseSpec(
                    "flag_write",
                    p.flag_write_cycles,
                    traffic=(xgmi_out(n_peers, 8),),
                ),
                PhaseSpec(
                    "local_tiles",
                    p.local_cycles,
                    traffic=(
                        reads(p.local_sector_reads, cfg.sector_bytes),
                        local_writes(p.local_partial_writes, data_bytes),
                    ),
                ),
                PhaseSpec("wait_flags", wait_addrs=wait_addrs),
                PhaseSpec(
                    "reduce",
                    p.reduce_cycles,
                    traffic=(reads(p.reduce_reads, cfg.elem_bytes),),
                ),
                PhaseSpec(
                    "broadcast",
                    p.broadcast_cycles,
                    traffic=(
                        xgmi_out(p.broadcast_xgmi_writes, data_bytes),
                        local_writes(p.broadcast_local_writes, data_bytes),
                    ),
                ),
            ),
        )

    def programs(self) -> List[WGProgram]:
        return [self._program(p) for p in self.workload.plans]

    def traces(self) -> TraceBundle:
        bundle = make_gemv_allreduce_traces(self.cfg, self.flag_delays_ns, self.amap)
        bundle.meta["scenario"] = self.name
        return bundle

    def expected_nonflag_reads(self) -> int:
        return self.workload.expected_nonflag_reads()

    # the closed-form vectorized engine understands exactly this scenario
    def run_vectorized(self, sim):
        from ..vector_engine import run_vectorized

        return run_vectorized(sim)
