"""Simulator and application configuration, the paper's Table 1 (port of
``repro/core/config.py``).

A copy of the reference's: the same fields, defaults and derived quantities,
so a sweep or a command line splits its keys between configuration fields and
scenario parameters exactly as the reference does.  The torch device a run
uses is not a field: ``simulate``, ``Eidola`` and ``SweepRunner`` take it.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Optional

__all__ = ["SyncPolicy", "EngineKind", "SimConfig"]


class SyncPolicy(str, enum.Enum):
    SPIN = "spin"          # baseline spin-wait polling loop (paper Fig. 6)
    SYNCMON = "syncmon"    # SyncMon-inspired monitor()/mwait() (paper Fig. 9)


class EngineKind(str, enum.Enum):
    CYCLE = "cycle"    # faithful per-cycle WTT head poll (paper §3.1)
    EVENT = "event"    # gem5-native event queue (paper §3.2.2, built here)
    VECTOR = "vector"  # vectorized batch replay (TPU-idiomatic rethink)


@dataclass(frozen=True)
class SimConfig:
    """Configuration for one Eidola kernel-launch simulation.

    Defaults reproduce the paper's Table 1:
      4 CUs in the simulated GPU, 3 emulated GPUs, 208 workgroups/GPU,
      M=256, K=8192, N=1.
    """

    # --- simulation configuration (Table 1, top half) ---
    n_cus: int = 4
    n_egpus: int = 3
    workgroups: int = 208
    clock_ghz: float = 1.5

    # --- application configuration (Table 1, bottom half) ---
    M: int = 256
    K: int = 8192          # TOTAL reduction dim; per-device slice is K/n_devices
    N: int = 1
    weak_scaling: bool = False  # if True, per-device slice is fixed at k_slice
    k_slice_override: Optional[int] = None

    # --- device timing model ---
    elem_bytes: int = 4
    sector_bytes: int = 32          # read granularity; 2 MB slice / 32 B = 65,536
    macs_per_cycle_per_cu: float = 128.0
    sectors_per_cycle_per_cu: float = 16.0
    dispatch_stagger_cycles: int = 8     # per-WG wave stagger on a CU
    flag_write_cycles: int = 8           # per peer-flag xGMI write issue
    reduce_cycles_per_row: int = 16
    broadcast_cycles_per_row: int = 4

    # --- synchronization model ---
    sync: SyncPolicy = SyncPolicy.SPIN
    poll_interval_cycles: int = 64  # spin loop period on an unset flag
    flag_check_cycles: int = 4      # observe-and-advance cost on a set flag
    wake_latency_cycles: int = 32   # SyncMon wake -> schedulable latency
    monitor_semantics: str = "mesa"
    # Calibrated race-window: cycles between the check read and the monitor
    # arming during which an arriving write causes an immediate mwait return
    # (and hence an extra validation read).  See EXPERIMENTS.md calibration.
    monitor_arm_cycles: int = 24

    # Woken wavefronts' first re-read is satisfied by the fill the waking
    # write triggered at the directory; simultaneous same-line validation
    # reads on one CU coalesce in pairs at the L1 MSHRs.  Subsequent
    # sequential flag checks miss (different lines, requeue jitter breaks
    # lockstep).  See EXPERIMENTS.md §SyncMon-calibration.
    wake_coalesce_width: int = 2
    requeue_jitter_mod: int = 16    # per-WG post-wake scheduler jitter (cycles)

    # xGMI directory visibility: a registered write issued at wakeupTime
    # becomes visible to the target's polls this much later (fabric hop +
    # directory processing under load).
    xgmi_enact_latency_ns: float = 1500.0

    # --- traffic replay ---
    include_data_writes: bool = True  # peers push partial tiles before flags
    data_write_lead_ns: float = 120.0  # partials land this long before the flag

    # --- engine selection ---
    engine: EngineKind = EngineKind.EVENT

    # --- reproducibility ---
    seed: int = 0

    # ------------------------------------------------------------------
    # derived quantities
    # ------------------------------------------------------------------

    @property
    def n_devices(self) -> int:
        return self.n_egpus + 1

    @property
    def k_slice(self) -> int:
        """Per-device K slice (column-parallel GEMV partitioning)."""
        if self.k_slice_override is not None:
            return self.k_slice_override
        if self.weak_scaling:
            return self.K
        if self.K % self.n_devices:
            raise ValueError(
                f"K={self.K} not divisible by n_devices={self.n_devices}"
            )
        return self.K // self.n_devices

    @property
    def rows_per_device(self) -> int:
        if self.M % self.n_devices:
            raise ValueError(
                f"M={self.M} not divisible by n_devices={self.n_devices}"
            )
        return self.M // self.n_devices

    @property
    def wg_mac_throughput(self) -> float:
        """Effective MACs/cycle per workgroup (symmetric CU sharing)."""
        return self.macs_per_cycle_per_cu * self.n_cus / self.workgroups

    @property
    def wg_sector_throughput(self) -> float:
        return self.sectors_per_cycle_per_cu * self.n_cus / self.workgroups

    @property
    def sectors_per_row(self) -> int:
        import math

        return math.ceil(self.k_slice * self.elem_bytes / self.sector_bytes)

    @property
    def row_cycles(self) -> int:
        """Cycles for one workgroup to produce one output-row partial."""
        import math

        compute = self.k_slice * self.N / self.wg_mac_throughput
        memory = self.sectors_per_row / self.wg_sector_throughput
        return max(1, math.ceil(max(compute, memory)))

    def ns_to_cycles(self, ns: float) -> int:
        return int(round(ns * self.clock_ghz))

    def cycles_to_ns(self, cycles: float) -> float:
        return cycles / self.clock_ghz

    def with_(self, **kw) -> "SimConfig":
        return replace(self, **kw)

    def with_devices(self, devices: int) -> "SimConfig":
        """Total-device-count sugar: ``n_egpus = devices - 1``.

        The single conversion point for every ``devices=`` surface
        (``simulate``, ``SweepRunner`` grids, the ``--devices`` CLI flag).
        """
        if devices < 2:
            raise ValueError("devices must be >= 2 (one target + peers)")
        return self.with_(n_egpus=int(devices) - 1)

    def validate(self) -> "SimConfig":
        """Scenario-independent sanity checks.

        GEMV-specific divisibility constraints (M, K vs. n_devices) are no
        longer enforced here — they fire lazily from ``k_slice`` /
        ``rows_per_device`` when the gemv_allreduce workload model actually
        uses them, so non-GEMV scenarios are free to pick any device count.
        """
        if self.n_cus <= 0 or self.workgroups <= 0 or self.n_egpus <= 0:
            raise ValueError("n_cus, workgroups, n_egpus must be positive")
        return self
