"""Trace rendering and export, the paper's Figs. 1, 2 and 8 (port of
``repro/core/trace_render.py``).

Per-workgroup phase segments can be exported as a Chrome-trace / Perfetto
JSON (openable at ui.perfetto.dev), as CSV, or rendered as a terminal ASCII
strip chart for quick inspection of ideal vs. non-ideal executions.

Not to be confused with ``core/cohort_timeline.py``, the closed forms of
the pod-scale timeline engine.  This module only draws and exports the
``Segment`` lists a simulation has already produced.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from .events import PHASE_COLORS, PHASE_GLYPHS as _GLYPH, Segment

__all__ = ["to_chrome_trace", "to_csv", "ascii_timeline", "phase_totals"]


def to_chrome_trace(
    segments: Sequence[Segment], *, device: int = 0, label: str = "GPU"
) -> str:
    """Chrome trace-event JSON; one tid per workgroup row, like the figures.

    Closed-loop (multi-device) segment lists map each simulated device to its
    own Chrome-trace process; ``device`` offsets the pid numbering.
    """
    events = []
    pids = set()
    for s in segments:
        pid = device + s.device
        pids.add(pid)
        events.append(
            {
                "name": s.phase,
                "cat": PHASE_COLORS.get(s.phase, "unknown"),
                "ph": "X",
                "ts": s.start_ns / 1000.0,  # chrome traces are in us
                "dur": max(s.dur_ns, 1e-3) / 1000.0,
                "pid": pid,
                "tid": s.wg,
                "args": {"phase": s.phase},
            }
        )
    meta = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {"name": f"{label}{pid}"},
        }
        for pid in sorted(pids or {device})
    ]
    return json.dumps({"traceEvents": meta + events})


def to_csv(segments: Sequence[Segment]) -> str:
    """CSV export; a ``device`` column is appended only for multi-device
    segment lists, keeping the single-device header stable."""
    multi = any(s.device for s in segments)
    lines = ["wg,phase,start_ns,end_ns" + (",device" if multi else "")]
    for s in segments:
        row = f"{s.wg},{s.phase},{s.start_ns:.3f},{s.end_ns:.3f}"
        if multi:
            row += f",{s.device}"
        lines.append(row)
    return "\n".join(lines)


def ascii_timeline(
    segments: Sequence[Segment],
    *,
    width: int = 100,
    max_rows: int = 16,
    row_stride: Optional[int] = None,
) -> str:
    """Terminal strip chart: one row per (sampled) workgroup.

    Glyphs: g/G compute (remote/local tiles), B flag write, r spin-wait,
    b reduce, ^ broadcast, . descheduled — mirroring the paper's palette.
    """
    if not segments:
        return "(no segments)"
    t_end = max(s.end_ns for s in segments)
    t_end = max(t_end, 1e-9)
    multi = any(s.device for s in segments)
    by_row: Dict[tuple, List[Segment]] = {}
    for s in segments:
        by_row.setdefault((s.device, s.wg), []).append(s)
    keys = sorted(by_row)
    stride = row_stride or max(1, len(keys) // max_rows)
    rows = []
    for dev, wg in keys[::stride][:max_rows]:
        row = [" "] * width
        for s in sorted(by_row[(dev, wg)], key=lambda x: x.start_ns):
            a = int(s.start_ns / t_end * (width - 1))
            b = int(s.end_ns / t_end * (width - 1))
            for i in range(a, max(a, b) + 1):
                row[i] = _GLYPH.get(s.phase, "?")
        tag = f"d{dev} wg{wg:4d}" if multi else f"wg{wg:4d}"
        rows.append(f"{tag} |" + "".join(row) + "|")
    header = f"t=0 {'-' * (width - 14)} t={t_end / 1000.0:.2f}us"
    return "\n".join([header] + rows)


def phase_totals(segments: Sequence[Segment]) -> Dict[str, float]:
    """Total ns spent per phase across all workgroups."""
    out: Dict[str, float] = {}
    for s in segments:
        out[s.phase] = out.get(s.phase, 0.0) + s.dur_ns
    return out
