"""Eidola simulator facade (port of ``repro/core/simulator.py``).

Wires together the address map, directory memory, Monitor Log, workload model,
WTT, and the selected engine; produces a :class:`Report` with the quantities
the paper measures (flag/non-flag reads, kernel span, per-WG timelines,
wall-clock simulation time).

The cycle and event engines are host interpreters, as in the reference; the
vector engine works on torch tensors on the run's device, which is resolved
when an :class:`Eidola` is built: the CUDA device unless the caller passes
``device="cpu"``, and an error, not a fallback, when there is no card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..device import resolve_device
from .config import EngineKind, SimConfig, SyncPolicy
from .engine import CyclePollEngine, EventQueueEngine
from .events import Segment, TraceBundle, effective_writes
from .memory import AddressMap, DirectoryMemory
from .monitor import MonitorLog
from .scenario import Scenario
from .target import TargetDevice
from .wtt import WriteTrackingTable

__all__ = ["Report", "Eidola", "run_gemv_allreduce"]


@dataclass
class Report:
    engine: str
    sync: str
    traffic: Dict[str, int]
    flag_reads: int
    nonflag_reads: int
    kernel_span_ns: float
    sim_cycles: int
    wall_time_s: float
    wtt_registered: int
    wtt_enacted: int
    wtt_head_polls: int
    scenario: str = "gemv_allreduce"
    monitor_stats: Dict[str, int] = field(default_factory=dict)
    segments: List[Segment] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)
    # multi-device (closed-loop cluster) breakdown; open-loop runs keep the
    # defaults (one detailed device, aggregate == device 0)
    n_devices: int = 1
    per_device: Dict[int, Dict[str, int]] = field(default_factory=dict)
    closed_loop: bool = False

    def summary(self) -> str:
        mode = f"|{self.n_devices}dev closed" if self.closed_loop else ""
        return (
            f"[{self.scenario}|{self.engine}/{self.sync}{mode}] "
            f"flag_reads={self.flag_reads} "
            f"nonflag_reads={self.nonflag_reads} "
            f"kernel={self.kernel_span_ns:.0f}ns "
            f"wall={self.wall_time_s * 1e3:.1f}ms"
        )

    def device_summary(self) -> str:
        """One line per device: flag/non-flag reads and xGMI in/out."""
        lines = []
        for d in sorted(self.per_device):
            t = self.per_device[d]
            lines.append(
                f"  device {d}: flag_reads={t.get('flag_reads', 0)} "
                f"nonflag_reads={t.get('nonflag_reads', 0)} "
                f"xgmi_in={t.get('xgmi_writes_in', 0)} "
                f"xgmi_out={t.get('xgmi_writes_out', 0)}"
            )
        return "\n".join(lines)


class Eidola:
    """One simulated kernel launch on a multi-device system.

    ``traces`` carries the eidolons' registered writes (the setup-kernel
    payload).  The simulation enacts each write at
    ``wakeup_ns + cfg.xgmi_enact_latency_ns`` — the paper's wakeupTime is the
    *issue* time; visibility at the target directory includes the fabric hop.

    ``scenario`` selects the detailed device's phase programs (see
    :mod:`repro_torch.core.scenario`); when omitted, the registered
    ``gemv_allreduce`` scenario is used.  Most callers should prefer
    :func:`repro_torch.core.scenario.simulate`, which builds matching traces
    too.  ``device`` is where the vector engine's tensors live: ``None`` is
    the CUDA device (an error without a card), ``"cpu"`` the host.
    """

    def __init__(
        self,
        cfg: SimConfig,
        traces: TraceBundle,
        *,
        scenario: Optional[Scenario] = None,
        amap: Optional[AddressMap] = None,
        perturb=None,
        collect_segments: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg.validate()
        self.traces = traces
        if scenario is not None and amap is not None and scenario.amap != amap:
            raise ValueError("scenario and Eidola were given different AddressMaps")
        if scenario is None:
            from .scenarios.gemv_allreduce import GemvAllReduceScenario

            scenario = GemvAllReduceScenario(
                cfg, amap or AddressMap(n_devices=cfg.n_devices)
            )
        self.scenario = scenario
        self.amap = scenario.amap
        self.perturb = perturb
        self.collect_segments = collect_segments

    def _build(self):
        cfg = self.cfg
        memory = DirectoryMemory(self.amap)
        monitor = (
            MonitorLog(
                memory,
                semantics=cfg.monitor_semantics,  # type: ignore[arg-type]
                wake_latency_cycles=cfg.wake_latency_cycles,
            )
            if cfg.sync == SyncPolicy.SYNCMON
            else None
        )
        device = TargetDevice(
            cfg, self.scenario, memory, monitor, perturb=self.perturb
        )
        wtt = WriteTrackingTable(clock_ghz=cfg.clock_ghz)
        wtt.register_many(
            effective_writes(
                self.traces,
                latency_ns=cfg.xgmi_enact_latency_ns,
                perturb=self.perturb,
            )
        )
        return memory, monitor, device, wtt

    def run(self) -> Report:
        cfg = self.cfg
        if cfg.engine == EngineKind.VECTOR:
            report = self.scenario.run_vectorized(self)
            if report is None:
                raise NotImplementedError(
                    f"scenario {self.scenario.name!r} has no vectorized engine; "
                    "use EngineKind.CYCLE or EngineKind.EVENT"
                )
            return report
        memory, monitor, device, wtt = self._build()
        engine = (
            CyclePollEngine() if cfg.engine == EngineKind.CYCLE else EventQueueEngine()
        )
        res = engine.run(device, wtt)
        return Report(
            engine=engine.name,
            sync=cfg.sync.value,
            traffic=memory.traffic.as_dict(),
            flag_reads=memory.traffic.flag_reads,
            nonflag_reads=memory.traffic.nonflag_reads,
            kernel_span_ns=cfg.cycles_to_ns(device.kernel_end_cycle),
            sim_cycles=res.sim_cycles,
            wall_time_s=res.wall_time_s,
            wtt_registered=wtt.stats.registered,
            wtt_enacted=wtt.stats.enacted,
            wtt_head_polls=res.head_polls,
            scenario=self.scenario.name,
            monitor_stats=dict(monitor.stats) if monitor else {},
            segments=device.collect_segments() if self.collect_segments else [],
            meta=dict(self.traces.meta),
            n_devices=1,
            per_device={0: memory.traffic.as_dict()},
            closed_loop=False,
        )


def run_gemv_allreduce(
    cfg: SimConfig,
    flag_delays_ns: Sequence[float] | float,
    *,
    perturb=None,
    collect_segments: bool = True,
    device=None,
) -> Report:
    """Convenience: build Table-1-style traces for ``cfg`` and simulate on
    ``device`` (see :class:`Eidola`).

    A thin wrapper over the registered ``gemv_allreduce`` scenario; new code
    should call :func:`repro_torch.core.scenario.simulate`.
    """
    from .scenarios.gemv_allreduce import GemvAllReduceScenario

    scenario = GemvAllReduceScenario(cfg, flag_delays_ns=flag_delays_ns)
    return Eidola(
        cfg,
        scenario.traces(),
        scenario=scenario,
        perturb=perturb,
        collect_segments=collect_segments,
        device=device,
    ).run()
