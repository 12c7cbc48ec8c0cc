"""Compatibility shim (port of ``repro/core/timeline.py``) — this module is
now :mod:`repro_torch.core.trace_render`.

``timeline`` historically held the Chrome-trace/CSV/ASCII *rendering*
helpers, which made it too easy to confuse with
:mod:`repro_torch.core.cohort_timeline`, the pod-scale timeline *engine*.  The
rendering code lives in :mod:`repro_torch.core.trace_render`; import from
there.
"""

from __future__ import annotations

from .trace_render import (  # noqa: F401
    ascii_timeline,
    phase_totals,
    to_chrome_trace,
    to_csv,
)

__all__ = ["to_chrome_trace", "to_csv", "ascii_timeline", "phase_totals"]
