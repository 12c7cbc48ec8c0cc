"""Event and trace schema of the Eidola simulator (port of
``repro/core/events.py``).

The paper's central data object is the *registered write*: a timestamped,
one-sided peer-to-peer write ``(addr, data, size, wakeupTime)`` registered by a
functional-mode setup kernel (``register_write`` pseudo-op, Fig. 5) and enacted
by the simulator when detailed time reaches ``wakeupTime``, plus the issuing
device ``src`` and a registration counter ``seq`` used only to break ties.

A :class:`TraceBundle` is the set of registered writes for one simulated
kernel launch with its metadata.  Its JSON is the reference's byte for byte in
both directions, so a bundle the port writes (``core/capture.py``'s
``schedule_to_trace``, ``core/workload.py``) replays in either package.
:class:`Segment` is one phase interval of a workgroup's timeline; the phase
names it accepts are this package's own registry (:func:`register_phase`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

__all__ = [
    "RegisteredWrite",
    "effective_writes",
    "TraceBundle",
    "Segment",
    "PHASES",
    "PHASE_COLORS",
    "PHASE_GLYPHS",
    "register_phase",
]

# ---------------------------------------------------------------------------
# Registered writes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RegisteredWrite:
    """One emulated peer-to-peer (xGMI-analogue) write.

    Attributes mirror the ``register_write`` pseudo-op of the paper:

    addr        destination byte address in the target device's memory space.
    data        value to be written (interpreted at ``size`` bytes).
    size        write width in bytes, 1..8 per the paper.
    wakeup_ns   offset after kernel launch, in nanoseconds, at which the write
                is issued.  Converted to cycles by the engine using the device
                clock from the simulator config.
    src         issuing device id (eidolon).  ``-1`` means "unattributed".
    seq         registration order; used only to keep pops deterministic when
                two writes share a timestamp.  The paper explicitly allows
                registration in arbitrary order ("sequential calls ... need not
                correspond to the chronological order of their execution").
    """

    wakeup_ns: float
    addr: int
    data: int
    size: int = 4
    src: int = -1
    seq: int = 0

    def __post_init__(self) -> None:
        if not (1 <= self.size <= 8):
            raise ValueError(f"write size must be in [1, 8] bytes, got {self.size}")
        if self.wakeup_ns < 0:
            raise ValueError(f"wakeup_ns must be >= 0, got {self.wakeup_ns}")
        if self.addr < 0:
            raise ValueError("addr must be non-negative")

    def sort_key(self) -> Tuple[float, int]:
        return (self.wakeup_ns, self.seq)


def effective_writes(
    writes: Sequence[RegisteredWrite],
    *,
    latency_ns: float = 0.0,
    perturb=None,
) -> List[RegisteredWrite]:
    """Trace writes as the engine will see them: enact latency + jitter.

    The shared no-perturb fast path: when ``perturb is None`` and
    ``latency_ns == 0`` the input writes are already effective and are
    returned as-is (one list copy, no dataclass churn) — previously both the
    vectorized engine and the single-device builder materialized a full
    :class:`RegisteredWrite` copy per trace write unconditionally.
    """
    if perturb is None and latency_ns == 0:
        return list(writes)
    out: List[RegisteredWrite] = []
    for w in writes:
        eff = (
            dataclasses.replace(w, wakeup_ns=w.wakeup_ns + latency_ns)
            if latency_ns
            else w
        )
        if perturb is not None:
            eff = perturb.jitter_write(eff)
        out.append(eff)
    return out


# ---------------------------------------------------------------------------
# Trace bundles
# ---------------------------------------------------------------------------


@dataclass
class TraceBundle:
    """A set of registered writes for one kernel launch, plus metadata."""

    writes: List[RegisteredWrite] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)

    # -- construction -------------------------------------------------------

    def add(
        self,
        *,
        wakeup_ns: float,
        addr: int,
        data: int,
        size: int = 4,
        src: int = -1,
    ) -> RegisteredWrite:
        w = RegisteredWrite(
            wakeup_ns=wakeup_ns,
            addr=addr,
            data=data,
            size=size,
            src=src,
            seq=len(self.writes),
        )
        self.writes.append(w)
        return w

    def extend(self, writes: Iterable[RegisteredWrite]) -> None:
        for w in writes:
            self.add(
                wakeup_ns=w.wakeup_ns, addr=w.addr, data=w.data, size=w.size, src=w.src
            )

    # -- views --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.writes)

    def __iter__(self) -> Iterator[RegisteredWrite]:
        return iter(self.writes)

    def sorted(self) -> List[RegisteredWrite]:
        return sorted(self.writes, key=RegisteredWrite.sort_key)

    def by_src(self) -> Dict[int, List[RegisteredWrite]]:
        out: Dict[int, List[RegisteredWrite]] = {}
        for w in self.writes:
            out.setdefault(w.src, []).append(w)
        return out

    def span_ns(self) -> float:
        return max((w.wakeup_ns for w in self.writes), default=0.0)

    def total_bytes(self) -> int:
        return sum(w.size for w in self.writes)

    # -- (de)serialization ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "meta": self.meta,
                "writes": [dataclasses.asdict(w) for w in self.writes],
            }
        )

    @classmethod
    def from_json(cls, text: str) -> "TraceBundle":
        obj = json.loads(text)
        bundle = cls(meta=dict(obj.get("meta", {})))
        for rec in obj.get("writes", []):
            bundle.writes.append(
                RegisteredWrite(
                    wakeup_ns=float(rec["wakeup_ns"]),
                    addr=int(rec["addr"]),
                    data=int(rec["data"]),
                    size=int(rec.get("size", 4)),
                    src=int(rec.get("src", -1)),
                    seq=int(rec.get("seq", 0)),
                )
            )
        return bundle

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TraceBundle":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# Timeline segments (Figs. 1/2 reproduction)
# ---------------------------------------------------------------------------

# Phase names of the fused GEMV+AllReduce pseudocode (paper Fig. 3) — the
# *canonical* gemv vocabulary only, frozen for the paper-figure legends.  The
# full set of valid Segment phases is ``PHASE_COLORS.keys()``, which scenarios
# extend at import time via register_phase(); consumers bucketing arbitrary
# scenarios' segments must iterate PHASE_COLORS, not this tuple.  The colors
# mirror the paper's color coordination: green = tile compute, brown = tile
# completion marker, blue = xGMI flag write, red = spin-wait, and we give the
# final reduce/broadcast its own shades.
PHASES: Tuple[str, ...] = (
    "remote_tiles",  # lines 2-5: compute partial tiles needed by remote GPUs
    "flag_write",    # line 7:    xGMI write to flags[my_gpu] on all peers
    "local_tiles",   # lines 9-12: compute partial tiles reduced locally
    "wait_flags",    # lines 14-15: spin on peer flags (red in Figs. 1/2)
    "reduce",        # line 17
    "broadcast",     # line 18
    "descheduled",   # SyncMon: wavefront yielded, not occupying the CU
)

PHASE_COLORS: Dict[str, str] = {
    "remote_tiles": "green",
    "flag_write": "blue",
    "local_tiles": "green",
    "wait_flags": "red",
    "reduce": "brown",
    "broadcast": "brown",
    "descheduled": "grey",
}

PHASE_GLYPHS: Dict[str, str] = {
    "remote_tiles": "g",
    "flag_write": "B",
    "local_tiles": "G",
    "wait_flags": "r",
    "reduce": "b",
    "broadcast": "^",
    "descheduled": ".",
}


def register_phase(name: str, *, color: str = "grey", glyph: str = "?") -> str:
    """Register a phase name so :class:`Segment` accepts it.

    The canonical fused-kernel phases above are pre-registered; scenarios
    (``core/scenarios``) register their own phase vocabularies at import
    time.  Re-registering an existing name is a no-op that keeps the original
    color/glyph (the gemv palette mirrors the paper and must stay stable).
    """
    if name not in PHASE_COLORS:
        PHASE_COLORS[name] = color
        PHASE_GLYPHS[name] = glyph
    return name


@dataclass(frozen=True)
class Segment:
    """One phase interval on one workgroup's timeline row.

    ``device`` identifies which simulated device the workgroup ran on; it is 0
    for single-detailed-device (open-loop) runs and meaningful in closed-loop
    cluster simulations.
    """

    wg: int
    phase: str
    start_ns: float
    end_ns: float
    device: int = 0

    def __post_init__(self) -> None:
        if self.phase not in PHASE_COLORS:
            raise ValueError(
                f"unknown phase {self.phase!r} (register it with register_phase)"
            )
        if self.end_ns < self.start_ns:
            raise ValueError("segment ends before it starts")

    @property
    def dur_ns(self) -> float:
        return self.end_ns - self.start_ns
