"""SyncMon-inspired Monitor Log (paper §5, Fig. 7) (port of
``repro/core/monitor.py``).

Implements the ``monitor()`` / ``mwait()`` pseudo-op semantics as a
simulator-side structure, exactly as the case study does: entries are keyed by
coherence-*line* address and hold a compare value, a monitor mask (derived from
the monitored byte range, accommodating padded flags), and the list of waiting
wavefront/workgroup ids.  Every write that completes at the directory is
compared (masked) against matching entries; on a hit all waiters are woken.

Two wake-up granularities are supported, as discussed in the paper:

* ``mesa``  — wake on *any* masked change of the line; the waiter must re-check
  its predicate (mwait sits inside the while loop).  This is the default and
  matches Mesa-style condition semantics.
* ``hoare`` — wake only when the masked comparison equals the registered
  wake value; the waiter may assume the predicate holds.

The Monitor Log doubles as the model of a semaphore-gated completion wait
(a stalled core consumes no memory bandwidth while waiting) when Eidola
replays the collective traffic ``core/capture.py`` records from a torch
program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Literal, Optional, Set, Tuple

from .memory import LINE_BYTES, DirectoryMemory

__all__ = ["MonitorEntry", "MonitorLog"]


@dataclass
class MonitorEntry:
    """One row of the Monitor Log (paper Fig. 7)."""

    line_addr: int
    compare_value: int  # full-line-width integer (little-endian byte order)
    monitor_mask: int   # full-line-width mask covering the monitored bytes
    waiting_wfs: Set[int] = field(default_factory=set)

    def matches(self, line_value: int, semantics: str) -> bool:
        if semantics == "hoare":
            return (line_value & self.monitor_mask) == (
                self.compare_value & self.monitor_mask
            )
        # mesa: any write that touches the monitored bytes is a wake event;
        # the match test happens in the waiter's re-check.
        return True


class MonitorLog:
    """Simulator-side Monitor Log with masked compare-on-write wake."""

    def __init__(
        self,
        memory: DirectoryMemory,
        *,
        semantics: Literal["mesa", "hoare"] = "mesa",
        wake_latency_cycles: int = 32,
    ):
        self.memory = memory
        self.semantics = semantics
        self.wake_latency_cycles = int(wake_latency_cycles)
        self._entries: Dict[int, List[MonitorEntry]] = {}
        # wf id -> cycle at which it becomes schedulable again
        self._pending_wakes: Dict[int, int] = {}
        self.stats = {
            "monitors_armed": 0,
            "mwaits": 0,
            "wakes": 0,
            "immediate_mwait_returns": 0,
            "writes_checked": 0,
        }
        memory.add_write_observer(self._on_directory_write)

    # -- pseudo-op: monitor(addr, numBytes, wakeValue) -------------------------

    def monitor(self, addr: int, num_bytes: int, wake_value: int) -> MonitorEntry:
        """Arm a monitor on ``num_bytes`` at ``addr`` with wake predicate.

        The mask covers [addr, addr+num_bytes) within the 64-byte line; the
        compare value is positioned at the same byte offsets.  Flexible sizes
        accommodate padded flags (paper: "size flexibility accommodates padded
        flags used to prevent false sharing").
        """
        if num_bytes <= 0 or num_bytes > LINE_BYTES:
            raise ValueError("monitored range must fit within one line")
        line = addr & ~(LINE_BYTES - 1)
        off = addr - line
        if off + num_bytes > LINE_BYTES:
            raise ValueError("monitored range may not straddle a line")
        mask = ((1 << (8 * num_bytes)) - 1) << (8 * off)
        cval = (wake_value & ((1 << (8 * num_bytes)) - 1)) << (8 * off)
        entry = MonitorEntry(line_addr=line, compare_value=cval, monitor_mask=mask)
        self._entries.setdefault(line, []).append(entry)
        self.stats["monitors_armed"] += 1
        return entry

    # -- pseudo-op: mwait(addr) -------------------------------------------------

    def mwait(self, entry: MonitorEntry, wf_id: int, now_cycle: int) -> bool:
        """Suspend ``wf_id`` until the entry's condition fires.

        Returns True if the condition ALREADY holds at call time (the classic
        monitor/mwait race window): the wavefront is not descheduled and the
        caller proceeds immediately.  Otherwise the wf is recorded as waiting
        and will be marked schedulable ``wake_latency_cycles`` after a matching
        directory write.
        """
        self.stats["mwaits"] += 1
        line_value = self._line_value(entry.line_addr)
        if (line_value & entry.monitor_mask) == (
            entry.compare_value & entry.monitor_mask
        ):
            self.stats["immediate_mwait_returns"] += 1
            return True
        entry.waiting_wfs.add(wf_id)
        return False

    # -- directory write hook -----------------------------------------------------

    def _on_directory_write(self, addr: int, data: int, size: int, cycle: int) -> None:
        line = addr & ~(LINE_BYTES - 1)
        entries = self._entries.get(line)
        if not entries:
            return
        self.stats["writes_checked"] += 1
        line_value = self._line_value(line)
        fired: List[MonitorEntry] = []
        for e in entries:
            if not e.waiting_wfs:
                continue
            if self.semantics == "hoare":
                hit = (line_value & e.monitor_mask) == (
                    e.compare_value & e.monitor_mask
                )
            else:
                # mesa: wake if the write overlapped the monitored bytes
                w_mask = ((1 << (8 * size)) - 1) << (8 * (addr - line))
                hit = bool(w_mask & e.monitor_mask)
            if hit:
                fired.append(e)
        for e in fired:
            for wf in e.waiting_wfs:
                wake_at = cycle + self.wake_latency_cycles
                prev = self._pending_wakes.get(wf)
                self._pending_wakes[wf] = min(prev, wake_at) if prev else wake_at
                self.stats["wakes"] += 1
            e.waiting_wfs.clear()

    # -- scheduler interface --------------------------------------------------------

    def pop_wakes_until(self, cycle: int) -> List[Tuple[int, int]]:
        """All (wf_id, wake_cycle) that become schedulable by ``cycle``."""
        due = [(wf, c) for wf, c in self._pending_wakes.items() if c <= cycle]
        for wf, _ in due:
            del self._pending_wakes[wf]
        return sorted(due, key=lambda t: (t[1], t[0]))

    def next_wake_cycle(self) -> Optional[int]:
        if not self._pending_wakes:
            return None
        return min(self._pending_wakes.values())

    def waiting_count(self) -> int:
        return sum(
            len(e.waiting_wfs) for lst in self._entries.values() for e in lst
        )

    # -- helpers -----------------------------------------------------------------------

    def _line_value(self, line_addr: int) -> int:
        return self.memory.peek(line_addr, LINE_BYTES)
