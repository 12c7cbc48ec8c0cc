"""The port's own spans (``repro_torch.tracing``) joined to a profiled batch.

Each kernel is joined to its launch call by the profiler's correlation id,
and the launch call to the innermost program span that was open on the host
when it was made: both on the profiler's clock (Unix-epoch ns, onto which
``tracing.drain`` moves the spans).  So a span's device time is that of the
kernels launched inside it, whenever the device ran them.  Spans on one
thread nest, so the innermost span open at an instant is the last one to
start before it, or the nearest of its ancestors that has not ended.

:func:`profile` is :func:`trace.profile` with tracing on and the launch
calls' correlation ids kept; :func:`span_metrics` reads the per-step
numbers of a batch from the join.  Run as a script, it makes one traced
run of a cell, as ``run.py --trace 1`` makes it, and prints what the spans
show beside the run's own result:

    python3 portbench/spans.py --workload <cell> --seed <n> [--seconds 10]
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Links:
    """A profile's kernel launch calls ``(start, end, correlation id)`` and
    kernels ``(correlation id, name, start, duration)``, in ns on the
    profiler's clock."""

    launches: List[Tuple[int, int, int]] = field(default_factory=list)
    kernels: List[Tuple[int, str, int, int]] = field(default_factory=list)


def links(prof) -> Links:
    """The :class:`Links` of a finished profile, its events told apart as
    ``trace._read`` tells them."""
    out = Links()
    for evt in prof.profiler.kineto_results.events():
        name, start, dur = evt.name(), evt.start_ns(), evt.duration_ns()
        if str(evt.device_type()).endswith("CUDA"):
            if not name.startswith(("ProfilerStep", "Memcpy", "Memset")):
                out.kernels.append((evt.correlation_id(), name, start, dur))
        elif name.startswith("cu") and "Launch" in name:
            out.launches.append((start, start + dur, evt.correlation_id()))
    return out


class Spans:
    """Drained spans, indexed to find the innermost one open at an instant."""

    def __init__(self, spans: list):
        self.spans = sorted(spans, key=lambda s: (s.start, s.id))
        self.by_id = {s.id: s for s in self.spans}
        self.starts = [s.start for s in self.spans]

    def at(self, t: int):
        """The innermost span open at ``t``, or None."""
        j = bisect.bisect_right(self.starts, t) - 1
        s = self.spans[j] if j >= 0 else None
        while s is not None and s.end < t:
            s = self.by_id.get(s.parent)
        return s

    def ancestor(self, s, name: str):
        """``s`` or its nearest ancestor named ``name``, or None."""
        while s is not None and s.name != name:
            s = self.by_id.get(s.parent)
        return s

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]


@dataclass
class Join:
    """Device ns of the kernels launched inside each span, its descendants'
    included (``inclusive``) and not (``own``), by span id; the profile's
    kernel ns; the ns and count of kernels whose launch call the profile
    lacks; the ns of kernels launched outside every span."""

    inclusive: Dict[int, int]
    own: Dict[int, int]
    kernel_ns: int
    unlaunched_ns: int
    unlaunched: int
    outside_ns: int

    @property
    def joined_ns(self) -> int:
        return self.kernel_ns - self.unlaunched_ns - self.outside_ns


def join(index: Spans, lk: Links) -> Join:
    """Each kernel to the innermost span open at its launch call's start."""
    launched = {corr: start for start, _, corr in lk.launches}
    inclusive: Dict[int, int] = defaultdict(int)
    own: Dict[int, int] = defaultdict(int)
    total = unlaunched_ns = unlaunched = outside = 0
    for corr, _, _, dur in lk.kernels:
        total += dur
        t = launched.get(corr)
        if t is None:
            unlaunched_ns += dur
            unlaunched += 1
            continue
        s = index.at(t)
        if s is None:
            outside += dur
            continue
        own[s.id] += dur
        while s is not None:
            inclusive[s.id] += dur
            s = index.by_id.get(s.parent)
    return Join(dict(inclusive), dict(own), total, unlaunched_ns, unlaunched, outside)


def span_metrics(index: Spans, j: Optional[Join]) -> Dict[str, Optional[float]]:
    """The batch's per-step numbers from its spans (None where there is
    nothing to read: no spans, no kernels, or kernels without their launch
    call, whose span is unknown):

    ``ssm_update_ms_per_step``   device ms of ``mamba.update`` in decode steps
                                 ÷ decode steps;
    ``shared_block_ms_per_step`` device ms of ``model.block`` spans of the
                                 shared block in decode steps ÷ decode steps;
    ``prefill_share``            % of the joined device time inside
                                 ``serve.prefill_step`` spans;
    ``host_dispatch_ms_per_step`` host ms of a ``serve.decode_step`` span, on
                                 average (the engine blocks only in
                                 ``serve.readback``, so this is the host's
                                 time to enqueue a step).
    """
    decode = index.named("serve.decode_step")
    out: Dict[str, Optional[float]] = dict.fromkeys(
        ("ssm_update_ms_per_step", "shared_block_ms_per_step", "prefill_share",
         "host_dispatch_ms_per_step"))
    if not decode:
        return out
    out["host_dispatch_ms_per_step"] = sum(s.end - s.start for s in decode) / len(decode) / 1e6
    if j is None or j.unlaunched or j.joined_ns <= 0:
        return out

    def decode_ms(pick: Callable) -> float:
        ns = sum(j.inclusive.get(s.id, 0) for s in index.spans
                 if pick(s) and index.ancestor(s, "serve.decode_step") is not None)
        return ns / 1e6 / len(decode)

    out["ssm_update_ms_per_step"] = decode_ms(lambda s: s.name == "mamba.update")
    out["shared_block_ms_per_step"] = decode_ms(
        lambda s: s.name == "model.block" and s.attrs.get("shared"))
    prefill = sum(j.inclusive.get(s.id, 0) for s in index.named("serve.prefill_step"))
    out["prefill_share"] = 100.0 * prefill / j.joined_ns
    return out


def idle_gaps(tr, index: Spans, n: int = 10) -> List[list]:
    """``tr.idle_gaps(n)`` with each gap that falls outside every CUDA call
    named by the innermost span open at its middle in place of ``python``."""
    segs = tr.busy_segments()
    gaps = sorted(((segs[i + 1][0] - segs[i][1], i) for i in range(len(segs) - 1)),
                  reverse=True)[:n]
    out = []
    for (label, seconds), (length, i) in zip(tr.idle_gaps(n), gaps):
        s = index.at(segs[i][1] + length // 2)
        if label.startswith("python ") and s is not None:
            label = s.name + label[len("python"):]
        out.append([label, seconds])
    return out


def readbacks_with_their_copy(tr, index: Spans) -> Tuple[int, int]:
    """``(serve.readback spans that hold a cudaMemcpyAsync call, all of
    them)``: where the two clocks agree, each holds the call of its read."""
    copies = sorted((s, e) for name, s, e in tr.calls if name.startswith("cudaMemcpy"))
    starts = [s for s, _ in copies]
    spans = index.named("serve.readback")
    held = 0
    for sp in spans:
        k = bisect.bisect_left(starts, sp.start)
        held += k < len(copies) and copies[k][1] <= sp.end
    return held, len(spans)


def profile(run: Callable[[], object], device):
    """``(Trace, Links, drained spans, run's result)``: :func:`trace.profile`'s
    session, with tracing on around it (without a card, no trace: None, None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile, schedule

    from portbench import trace
    from repro_torch import tracing

    ready: list = []
    tracing.enable()
    try:
        if device.type != "cuda":
            out = run()
        else:
            with _profile(activities=[ProfilerActivity.CUDA],
                          schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                          on_trace_ready=lambda p: ready.append((trace._read(p), links(p)))
                          ) as prof:
                torch.ones(8, device=device).mul_(2).sum().item()
                torch.cuda.synchronize(device)
                prof.step()
                torch.zeros(1).to(device)
                out = run()
                torch.zeros(1).to(device)
                torch.cuda.synchronize(device)
                prof.step()
    finally:
        tracing.disable()
        spans = tracing.drain()
    if not ready:
        return None, None, spans, out
    return ready[0][0], ready[0][1], spans, out


def _label(index: Spans, s) -> str:
    """A span's name in the breakdown: a block's kind (``shared`` for the
    shared block) added, and ``prefill:`` or ``decode:`` before a span
    inside a step."""
    name = s.name
    if name == "model.block":
        name += "[shared]" if s.attrs.get("shared") else f"[{s.attrs.get('kind')}]"
    for step, kind in (("serve.prefill_step", "prefill"), ("serve.decode_step", "decode")):
        up = index.ancestor(index.by_id.get(s.parent), step)
        if up is not None:
            return f"{kind}: {name}"
    return name


def report(tr, lk: Links, spans: list) -> dict:
    """What the spans show of one traced batch: the per-step numbers, the
    two checks of the join, the host's ms a decode step inside launch calls
    (which block while the device's queue is full), device and host seconds
    by span (:func:`_label`; a span's own device time, its inner spans' left
    out), the idle gaps named by span, and the device's idle seconds between
    its first and last event summed by span.  A launch call that takes far
    more than the median one waited for room in the device's queue."""
    index = Spans(spans)
    j = join(index, lk)
    held, readbacks = readbacks_with_their_copy(tr, index)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
    for s in index.spans:
        by_name[_label(index, s)][0] += j.own.get(s.id, 0) / 1e9
        by_name[_label(index, s)][1] += (s.end - s.start) / 1e9
    per_update: Dict[int, int] = defaultdict(int)
    in_launch = []  # host ns of each launch call inside a decode step
    for start, end, _ in lk.launches:
        s = index.at(start)
        if s is not None and s.name == "mamba.update":
            per_update[s.id] += 1
        if index.ancestor(s, "serve.decode_step") is not None:
            in_launch.append(end - start)
    in_launch.sort()
    counts = sorted(set(per_update.values()))
    idle: Dict[str, float] = defaultdict(float)  # each gap by the span open at its middle
    segs = tr.busy_segments()
    for (_, end), (start, _) in zip(segs, segs[1:]):
        s = index.at(end + (start - end) // 2)
        idle["outside spans" if s is None else _label(index, s)] += (start - end) / 1e9
    steps = len(index.named("serve.decode_step"))
    return {
        "metrics": span_metrics(index, j),
        "decode_steps": steps,
        "launch_call_ms_per_decode_step": sum(in_launch) / 1e6 / steps if steps else None,
        "launch_call_us_median_max": ([in_launch[len(in_launch) // 2] / 1e3, in_launch[-1] / 1e3]
                                      if in_launch else None),
        "readbacks_holding_their_copy": [held, readbacks],
        "kernel_s": j.kernel_ns / 1e9, "joined_s": j.joined_ns / 1e9,
        "joined_share": j.joined_ns / j.kernel_ns if j.kernel_ns else None,
        "kernels_without_launch": j.unlaunched,
        "launches_per_mamba_update": [counts[0], counts[-1]] if counts else None,
        "by_span": {k: {"device_s_own": v[0], "host_s": v[1]} for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1][0])},
        "idle_gaps": idle_gaps(tr, index),
        "idle_s_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10)
    args = ap.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    from portbench import run, trace

    kept: dict = {}

    def traced(fn, device):  # run.py's --trace 1 path, through this module's profile
        tr, lk, spans, out = profile(fn, device)
        kept.update(trace=tr, links=lk, spans=spans)
        return tr, out

    trace.profile = traced
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or kept.get("trace") is None:
        return rc or 1
    out = report(kept["trace"], kept["links"], kept["spans"])
    for key in ("decode_steps", "readbacks_holding_their_copy", "kernel_s", "joined_s",
                "joined_share", "kernels_without_launch", "launches_per_mamba_update",
                "launch_call_ms_per_decode_step", "launch_call_us_median_max", "metrics"):
        print(f"[spans] {key}: {out[key]}", file=sys.stderr)
    print(json.dumps({"spans": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
