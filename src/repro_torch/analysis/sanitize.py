"""Runtime traffic sanitizer: physical-consistency checks on a closed loop
(port of ``repro/analysis/sanitize.py``).

The static verifier (:mod:`repro_torch.analysis.verify`) reasons about programs;
this module cross-checks the *engines*: with ``Cluster(sanitize=True)`` a
:class:`TrafficSanitizer` shadows every emission and every enacted directory
write and, at the end of the run, asserts three invariants the fabric and
calendar accounting must uphold:

* **byte conservation** — the fabric's global and per-link-class
  ``*_messages`` / ``*_bytes`` counters equal an independent re-walk of each
  emission over :meth:`FabricModel.legs` (catching divergence between the
  sequential and the vectorized ``transfer_batch`` pricing paths);
* **monotonic calendar cycles** — no device ever enacts a write at an earlier
  cycle than a previous one (the engines' intra-cycle ordering contract);
* **exactly-once flag delivery** — every emitted or seeded flag write is
  enacted at its destination directory exactly once, no more, no fewer.

The shadow state is append-only and the hooks never touch simulated state, so
a sanitized run stays bit-identical to an unsanitized one (asserted against
the committed bench rows in the tests).  Violations raise
:class:`SanitizerError` listing every broken invariant.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

__all__ = ["SanitizerError", "TrafficSanitizer"]


class SanitizerError(RuntimeError):
    """One or more physical-consistency invariants failed after a run."""


class TrafficSanitizer:
    """Shadow accounting for one :class:`repro_torch.core.cluster.Cluster` run."""

    def __init__(self, amap, fabric, n_devices: int):
        self.amap = amap
        self.fabric = fabric
        self.n_devices = n_devices
        # mirrors FabricModel.stats' integer keys (queued_ns is timing, not
        # conservation — the fabric owns it)
        self.expected: Dict[str, int] = {"messages": 0, "bytes": 0}
        for name in fabric.spec.link_classes:
            self.expected[name + "_messages"] = 0
            self.expected[name + "_bytes"] = 0
        # (dst device, addr) -> flag writes put in flight / enacted
        self.expected_flags: Dict[Tuple[int, int], int] = {}
        self.enacted_flags: Dict[Tuple[int, int], int] = {}
        self._last_cycle: List[int] = [-1] * n_devices
        self.violations: List[str] = []

    # ------------------------------------------------------------------
    # hooks (called by the Cluster; must never mutate simulated state)
    # ------------------------------------------------------------------

    def observer_for(self, device: int) -> Callable[[int, int, int, int], None]:
        """A :meth:`DirectoryMemory.add_write_observer` callback for one
        device: checks calendar monotonicity and tallies flag enactments."""

        def observe(addr: int, data: int, size: int, cycle: int) -> None:
            last = self._last_cycle[device]
            if cycle < last:
                self.violations.append(
                    f"calendar ran backwards on device {device}: write at "
                    f"0x{addr:x} enacted at cycle {cycle} after cycle {last}"
                )
            else:
                self._last_cycle[device] = cycle
            if self.amap.is_flag(addr):
                key = (device, addr)
                self.enacted_flags[key] = self.enacted_flags.get(key, 0) + 1

        return observe

    def note_seed_write(self, device: int, addr: int) -> None:
        """A pre-scheduled trace write registered into ``device``'s WTT."""
        if self.amap.is_flag(addr):
            key = (device, addr)
            self.expected_flags[key] = self.expected_flags.get(key, 0) + 1

    def note_emission(
        self,
        src: int,
        dst: int,
        addr: int,
        nbytes: int,
        issue_ns: float,
        arrival_ns: float,
    ) -> None:
        """One routed emission: re-walk its legs and expect its flag."""
        nb = max(0, nbytes)
        self.expected["messages"] += 1
        self.expected["bytes"] += nb
        # legs() is memoized and stat-free, so this re-walk cannot perturb
        # the fabric's own accounting
        for leg in self.fabric.legs(src, dst):
            self.expected[leg.cls + "_messages"] += 1
            self.expected[leg.cls + "_bytes"] += nb
        if arrival_ns < issue_ns:
            self.violations.append(
                f"acausal transfer {src} -> {dst}: issued at {issue_ns}ns "
                f"but arrived at {arrival_ns}ns"
            )
        if self.amap.is_flag(addr):
            key = (dst, addr)
            self.expected_flags[key] = self.expected_flags.get(key, 0) + 1

    # ------------------------------------------------------------------
    # the end-of-run verdict
    # ------------------------------------------------------------------

    def check(self) -> None:
        """Raise :class:`SanitizerError` if any invariant was violated."""
        problems = list(self.violations)
        stats = self.fabric.stats
        for key in sorted(self.expected):
            got = stats.get(key, 0)
            want = self.expected[key]
            if got != want:
                problems.append(
                    f"byte conservation: fabric stat {key!r} is {got} but "
                    f"leg accounting of the emissions expects {want}"
                )
        for key in sorted(set(self.expected_flags) | set(self.enacted_flags)):
            want = self.expected_flags.get(key, 0)
            got = self.enacted_flags.get(key, 0)
            if got != want:
                device, addr = key
                decoded = self.amap.decode_flag(addr)
                what = f"flag 0x{addr:x}"
                if decoded is not None:
                    what = f"flag(src={decoded[0]}, slot={decoded[1]})"
                problems.append(
                    f"flag delivery: {what} on device {device} enacted "
                    f"{got}x but {want} write(s) were put in flight"
                )
        if problems:
            raise SanitizerError(
                "traffic sanitizer found "
                f"{len(problems)} violation(s):\n  " + "\n  ".join(problems)
            )
