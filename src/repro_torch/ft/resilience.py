"""Fault-tolerance substrate (port of ``repro/ft/resilience.py``).

:class:`SimulatedFailure` is what a failure injector raises into the
trainer's restart loop.  :class:`HeartbeatMonitor` marks a host dead after
``timeout_s`` without a heartbeat (its clock injectable);
:class:`StragglerMonitor` flags hosts whose rolling median step time exceeds
``threshold`` times the fleet's.  :class:`ElasticMeshManager` and
:func:`remesh_pytree` shrink the mesh after failures and re-place state on
the new mesh, values bit for bit.  A device is a global rank of the world.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..distributed.sharding import gather_tensor, shard_tensor
from ..launch.mesh import Mesh

__all__ = ["SimulatedFailure", "HeartbeatMonitor", "StragglerMonitor", "StragglerReport",
           "ElasticMeshManager", "remesh_pytree"]


class SimulatedFailure(RuntimeError):
    """Injected node/step failure (tests and chaos drills)."""


class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[int], timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        now = clock()
        self._last: Dict[int, float] = {h: now for h in hosts}
        self._dead: set = set()

    def beat(self, host: int, at: Optional[float] = None) -> None:
        if host in self._dead:
            return
        self._last[host] = self._clock() if at is None else at

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        t = self._clock() if now is None else now
        for h, last in self._last.items():
            if h not in self._dead and t - last > self.timeout_s:
                self._dead.add(h)
        return sorted(self._dead)

    def alive_hosts(self) -> List[int]:
        self.dead_hosts()
        return sorted(set(self._last) - self._dead)


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


def remesh_pytree(tree: Dict[str, torch.Tensor], shardings_fn: Callable, new_mesh, *,
                  old_mesh) -> Optional[Dict[str, torch.Tensor]]:
    """Re-place every tensor of ``tree`` (``{name: this rank's shard}`` on the
    bound ``old_mesh``) onto ``new_mesh``.

    ``shardings_fn(mesh)`` gives ``{name: spec}`` for a mesh, so the same rules
    resolve against either topology, fallbacks included.  Every rank of the
    old mesh gathers each whole tensor to the host and keeps the chunk that
    it holds on the new mesh: values are preserved exactly.  A rank outside
    the new mesh gets None.
    """
    old, new = shardings_fn(old_mesh), shardings_fn(new_mesh)
    host = {k: gather_tensor(v, old[k], old_mesh).cpu() for k, v in tree.items()}
    coord = new_mesh.coords(old_mesh.rank)
    if coord is None:
        return None
    return {k: shard_tensor(v, new[k], new_mesh, coord).clone() for k, v in host.items()}


class ElasticMeshManager:
    """Tracks the usable ranks and rebuilds meshes after failures.

    The mesh shrinks along the data axis (model-parallel groups are atomic:
    losing one rank removes its whole model-parallel replica), the standard
    elastic policy for 2D DP x TP meshes.
    """

    def __init__(self, devices: Sequence[int], axis_names=("data", "model"),
                 model_parallel: int = 1):
        self.all_devices = list(devices)
        self.axis_names = axis_names
        self.model_parallel = model_parallel
        self.failed: set = set()

    def fail_devices(self, idxs: Sequence[int]) -> None:
        self.failed.update(idxs)

    def current_mesh(self) -> Mesh:
        alive = [d for i, d in enumerate(self.all_devices) if i not in self.failed]
        mp = self.model_parallel
        groups = len(alive) // mp
        if groups < 1:
            raise SimulatedFailure("not enough devices for one model replica")
        return Mesh(dict(zip(self.axis_names, (groups, mp))), alive[: groups * mp])

    def dp_size(self) -> int:
        return self.current_mesh().shape[self.axis_names[0]]
