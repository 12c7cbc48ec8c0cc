"""Injected failures and straggler statistics (a copy of part of
``repro/ft/resilience.py``).

:class:`SimulatedFailure` is what a failure injector raises into the
trainer's restart loop; :class:`StragglerMonitor` flags hosts whose rolling
median step time exceeds ``threshold`` times the fleet's.  The heartbeat
monitor, the elastic mesh and ``remesh_pytree`` come with the sharded
substrate (slice 4b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

__all__ = ["SimulatedFailure", "StragglerMonitor", "StragglerReport"]


class SimulatedFailure(RuntimeError):
    """Injected node/step failure (tests and chaos drills)."""


@dataclass
class StragglerReport:
    step: int
    stragglers: List[int]
    median_s: float
    worst_ratio: float


class StragglerMonitor:
    """Rolling per-host step-time stats with threshold flagging."""

    def __init__(self, threshold: float = 1.5, window: int = 16):
        self.threshold = threshold
        self.window = window
        self._hist: Dict[int, List[float]] = {}
        self._step = 0

    def record_step(self, host_times_s: Dict[int, float]) -> StragglerReport:
        self._step += 1
        for h, t in host_times_s.items():
            self._hist.setdefault(h, []).append(t)
            self._hist[h] = self._hist[h][-self.window:]
        med_per_host = {h: float(np.median(v)) for h, v in self._hist.items()}
        fleet_median = float(np.median(list(med_per_host.values())))
        stragglers = [h for h, m in med_per_host.items() if m > self.threshold * fleet_median]
        worst = max(med_per_host.values()) / max(fleet_median, 1e-9)
        return StragglerReport(self._step, sorted(stragglers), fleet_median, worst)
