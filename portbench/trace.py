"""One batch under ``torch.profiler``, read into what the per-layer readers need.

The profile records the device's activity alone (kernels, copies, sets, and
the host's CUDA calls that the device's tracer sees), not the host's torch
ops: recording the ~10^6 host ops of a batch slowed olmoe-1b-7b's
host-bound batch from 7.4 to 12.1 s (NVIDIA H100 80GB HBM3, 700 W).  The device's events are summed from
the profile's raw events (``profiler.kineto_results.events()``), as the
repository's ``chip_smoke.py`` sums them: ``key_averages()`` builds every
event into Python objects first.  The profile follows one warm-up cycle
whose events are dropped, since a session can miss its first records; it
is complete where every kernel launch call of the batch has its kernel.
A one-element copy to the device runs just before the batch and just after
its last sync, so the device's first and last events bracket the batch:
the window is the span between them on the device's clock.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

NAME_CHARS = 160  # kernel names in the breakdown (templated names run to thousands)


class Trace:
    """A profiled batch: its window, the device's events inside it, and the
    host's CUDA calls (all times in ns on the profiler's clock)."""

    def __init__(self, window: Tuple[int, int], kernels: List[Tuple[str, int, int]],
                 other_device: List[Tuple[str, int, int]], launches: int,
                 calls: List[Tuple[str, int, int]]):
        self.window = window
        self.kernels = kernels            # (name, start, duration)
        self.other_device = other_device  # copies and sets: (name, start, duration)
        self.launches = launches          # kernel launch calls the host made
        self.calls = calls                # the host's other CUDA calls: (name, start, end)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def complete(self) -> bool:
        """Whether every launch call has its kernel's record (true where
        the tracer saw no launch calls at all)."""
        return len(self.kernels) >= self.launches

    def busy_segments(self) -> List[Tuple[int, int]]:
        """The union of every device event's interval."""
        out: List[Tuple[int, int]] = []
        for s, e in sorted((s, s + d) for _, s, d in self.kernels + self.other_device):
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_segments()) / 1e9

    def kernel_seconds(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """``(device seconds, launches)`` of the kernels whose name matches."""
        mine = [d for name, _, d in self.kernels if match(name)]
        return sum(mine) / 1e9, len(mine)

    def top_kernels(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took the most time: ``[name, seconds]``."""
        total: Dict[str, float] = defaultdict(float)
        for name, _, d in self.kernels + self.other_device:
            total[name[:NAME_CHARS]] += d / 1e9
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches with nothing on the device, each named
        by what the host was doing at its middle, as far as the tracer sees
        it: the CUDA call it was in, else ``python`` (host code between CUDA
        calls), and the device operation that the gap follows."""
        segs = self.busy_segments()
        ends = [e for _, e in segs]
        gaps = sorted(((segs[i + 1][0] - segs[i][1], i) for i in range(len(segs) - 1)),
                      reverse=True)[:n]
        after = sorted((s + d, name) for name, s, d in self.kernels + self.other_device)
        after_end = [t for t, _ in after]
        calls = sorted(self.calls, key=lambda c: c[1])
        starts = [c[1] for c in calls]
        out = []
        for length, i in gaps:
            mid = ends[i] + length // 2
            j = bisect.bisect_right(starts, mid) - 1
            doing = calls[j][0] if j >= 0 and calls[j][2] >= mid else "python"
            k = bisect.bisect_right(after_end, ends[i]) - 1
            prev = after[k][1][:NAME_CHARS // 2] if k >= 0 else "start"
            out.append([f"{doing} after {prev}", length / 1e9])
        return out


def _read(prof) -> Trace:
    """The :class:`Trace` of a finished profile.  Events are told apart by
    their device and name: on the device a copy or a set where its name says
    so, an annotation of the profiler's own (``ProfilerStep#``) left out, a
    kernel otherwise; on the host a kernel launch call (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ...) or another CUDA call."""
    kernels, other, calls, launches = [], [], [], 0
    for evt in prof.profiler.kineto_results.events():
        name, start, dur = evt.name(), evt.start_ns(), evt.duration_ns()
        if str(evt.device_type()).endswith("CUDA"):
            if name.startswith("ProfilerStep"):
                continue
            (other if name.startswith(("Memcpy", "Memset")) else kernels).append(
                (name, start, dur))
        elif name.startswith("cu"):
            if "Launch" in name:
                launches += 1
            else:
                calls.append((name, start, start + dur))
    events = kernels + other
    if not events:
        raise RuntimeError("the profile holds no device event")
    window = (min(s for _, s, _ in events), max(s + d for _, s, d in events))
    return Trace(window, kernels, other, launches, calls)


def profile(run: Callable[[], object], device: torch.device):
    """``(Trace, run's result)``: ``run()`` under the profiler, after one
    warm-up cycle of a few tiny device ops, between two device marks.
    Without a card there is nothing to trace: the trace is None."""
    if device.type != "cuda":
        return None, run()
    from torch.profiler import ProfilerActivity, profile as _profile, schedule

    ready: List[Trace] = []
    with _profile(activities=[ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                  on_trace_ready=lambda p: ready.append(_read(p))) as prof:
        torch.ones(8, device=device).mul_(2).sum().item()
        torch.cuda.synchronize(device)
        prof.step()
        torch.zeros(1).to(device)
        out = run()
        torch.zeros(1).to(device)
        torch.cuda.synchronize(device)
        prof.step()
    return ready[0], out
