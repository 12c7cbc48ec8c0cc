"""The simulated address map (port of ``AddressMap`` in ``repro/core/memory.py``).

A copy of the part of the layout that ``core/capture.py``'s
``schedule_to_trace`` reads: the flag region (``flag_addr``) and the base of
the peer partial-tile buffers (``partial_base``), at the reference's default
bases, so a trace the port writes addresses the memory the reference's
simulator models.  The flag slots, packed flags and the slot-claim
bookkeeping are not copied: the trace uses none of them.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["AddressMap"]


@dataclass(frozen=True)
class AddressMap:
    """One padded flag variable a device from ``flag_base``, ``flag_stride``
    apart; peer partial-tile buffers from ``partial_base``."""

    flag_base: int = 0x3F_D004_F00
    flag_stride: int = 64  # a coherence line: padded flags, no false sharing
    n_devices: int = 4
    partial_base: int = 0x3F_E000_000

    def flag_addr(self, src_device: int) -> int:
        """Address of ``flags[src_device]`` in the target's memory."""
        if not (0 <= src_device < self.n_devices):
            raise ValueError(f"device {src_device} out of range")
        return self.flag_base + self.flag_stride * src_device
