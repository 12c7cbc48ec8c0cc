"""Runtime-variability models (paper §1, Figs. 1 vs 2) (port of
``repro/core/perturb.py``).

The paper's characterization shows that *identical* kernels on *identical*
hardware exhibit very different timelines run-to-run because of transient
network traffic and contention.  Eidola supports studying this by perturbing
(a) per-workgroup phase durations (clock/contention jitter on the detailed
device) and (b) registered-write timestamps (network-induced delay on the
eidolons' writes).  All perturbations are deterministic functions of
(seed, workgroup/write identity) so every engine sees the same perturbation.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from .events import RegisteredWrite

__all__ = ["NullPerturb", "GaussianPerturb", "PeerDelayPerturb", "compose"]


def _rng(seed: int, *key) -> np.random.Generator:
    h = zlib.crc32(("|".join(str(k) for k in key) + f"#{seed}").encode())
    return np.random.default_rng(h)


class NullPerturb:
    def scale_phase(self, wg: int, state: str, base_cycles: int) -> int:
        return base_cycles

    def jitter_write(self, w: RegisteredWrite) -> RegisteredWrite:
        return w


@dataclass
class GaussianPerturb:
    """Multiplicative lognormal-ish jitter on phases and additive on writes."""

    seed: int = 0
    phase_sigma: float = 0.0       # relative sigma on phase durations
    write_sigma_ns: float = 0.0    # additive sigma on write wakeups

    def scale_phase(self, wg: int, state: str, base_cycles: int) -> int:
        if self.phase_sigma <= 0:
            return base_cycles
        g = _rng(self.seed, "phase", wg, state).normal(0.0, self.phase_sigma)
        return max(1, int(round(base_cycles * float(np.exp(g)))))

    def jitter_write(self, w: RegisteredWrite) -> RegisteredWrite:
        if self.write_sigma_ns <= 0:
            return w
        d = float(
            _rng(self.seed, "write", w.src, w.seq).normal(0.0, self.write_sigma_ns)
        )
        return RegisteredWrite(
            wakeup_ns=max(0.0, w.wakeup_ns + d),
            addr=w.addr,
            data=w.data,
            size=w.size,
            src=w.src,
            seq=w.seq,
        )


@dataclass
class PeerDelayPerturb:
    """Delay specific eidolons' writes (the paper's Fig. 2 non-ideal case,
    where GPUs 2 and 3 are held up by transient fabric contention)."""

    extra_delay_ns: Dict[int, float] = field(default_factory=dict)

    def scale_phase(self, wg: int, state: str, base_cycles: int) -> int:
        return base_cycles

    def jitter_write(self, w: RegisteredWrite) -> RegisteredWrite:
        d = self.extra_delay_ns.get(w.src, 0.0)
        if not d:
            return w
        return RegisteredWrite(
            wakeup_ns=w.wakeup_ns + d,
            addr=w.addr,
            data=w.data,
            size=w.size,
            src=w.src,
            seq=w.seq,
        )


class compose:
    """Apply several perturbations in sequence."""

    def __init__(self, *perturbs):
        self.perturbs = perturbs

    def scale_phase(self, wg: int, state: str, base_cycles: int) -> int:
        for p in self.perturbs:
            base_cycles = p.scale_phase(wg, state, base_cycles)
        return base_cycles

    def jitter_write(self, w: RegisteredWrite) -> RegisteredWrite:
        for p in self.perturbs:
            w = p.jitter_write(w)
        return w
