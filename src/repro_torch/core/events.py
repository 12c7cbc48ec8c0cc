"""The registered write and the trace bundle (port of ``RegisteredWrite`` and
``TraceBundle`` in ``repro/core/events.py``).

A copy of what the capture bridge needs: the paper's registered write, a
timestamped one-sided peer write ``(addr, data, size, wakeupTime)`` with the
issuing device ``src`` and a registration counter ``seq``, and the bundle of
writes for one kernel launch with its metadata, written and read as JSON in
the reference's format, so that the reference's simulator
(``repro.core.Eidola``) replays a bundle the port writes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

__all__ = ["RegisteredWrite", "TraceBundle"]


@dataclass(frozen=True)
class RegisteredWrite:
    """One emulated peer-to-peer write: ``addr`` in the target's memory,
    ``data`` at ``size`` bytes (1..8), issued ``wakeup_ns`` after launch by
    device ``src`` (-1: unattributed); ``seq`` breaks ties in time."""

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


@dataclass
class TraceBundle:
    """A set of registered writes for one kernel launch, plus metadata."""

    writes: List[RegisteredWrite] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)

    def add(self, *, wakeup_ns: float, addr: int, data: int, size: int = 4,
            src: int = -1) -> RegisteredWrite:
        w = RegisteredWrite(wakeup_ns=wakeup_ns, addr=addr, data=data, size=size, src=src,
                            seq=len(self.writes))
        self.writes.append(w)
        return w

    def __len__(self) -> int:
        return len(self.writes)

    def __iter__(self) -> Iterator[RegisteredWrite]:
        return iter(self.writes)

    def span_ns(self) -> float:
        return max((w.wakeup_ns for w in self.writes), default=0.0)

    def total_bytes(self) -> int:
        return sum(w.size for w in self.writes)

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
