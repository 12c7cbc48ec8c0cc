"""Spans of the port's own layers, on the profiler's clock.

Off by default.  While off, :func:`span` checks one module flag and returns
one shared no-op context manager: it reads no clock and records nothing.
While on, each span records its name, an id, the id of the span that was
open around it (its parent), the id of its outermost ancestor (its batch:
every span inside one ``serve.batch`` shares it), its attributes, and its
host start and end on ``time.perf_counter_ns``.  Spans are kept in memory,
in the order they opened.

:func:`enable` reads one anchor pair ``(perf_counter_ns, time_ns)``;
:func:`drain` hands back the recorded spans with their times moved onto
``time_ns``, the Unix-epoch nanoseconds that ``torch.profiler`` stamps its
events with, and empties the list.  So a caller that profiles the device
can join each kernel's launch call to the innermost span open when it was
made.  There is no exporter: the caller (an operator, the benchmark) calls
``enable``, runs, and calls ``drain`` and :func:`disable`.

The spans the serving path records (a span's attributes in brackets):

- ``serve.batch`` (index, rows, prompt_len): ``ServeEngine._run_batch``;
- ``serve.prefill_step`` / ``serve.decode_step`` (pos): each call of
  ``Model.decode_step`` for a prompt token / a new token;
- ``serve.sample``, ``serve.readback`` (a decode step's token read back and
  the end-token check), ``serve.gather`` (the batch's new tokens read back);
- ``model.embed``, ``model.block`` (index, kind, shared), ``model.head``:
  ``Model.decode_step``'s parts, one ``model.block`` per applied block;
- ``mamba.update``: the Mamba2 recurrence of a decode step
  (``models/ssm.py::_ssm_step``).

Counters stay where the port keeps them: ``ServeEngine.stats`` and the
kernels' ``launches``.  One process, one thread: the open spans are one
stack.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = ["Span", "span", "enable", "disable", "drain"]


@dataclass
class Span:
    """One recorded span: times on ``perf_counter_ns`` while recorded, on
    ``time_ns`` once drained (``end`` is 0 while the span is open)."""

    name: str
    id: int
    parent: int  # 0 for an outermost span
    batch: int   # the outermost ancestor's id (its own where it is outermost)
    start: int
    end: int = 0
    attrs: Dict[str, object] = field(default_factory=dict)

    def __enter__(self) -> "Span":
        top = _open[-1] if _open else None
        self.parent = top.id if top else 0
        self.batch = top.batch if top else self.id
        _open.append(self)
        _spans.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        _open.pop()
        return False


class _Off:
    """The shared span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()
_on = False
_anchor: Tuple[int, int] = (0, 0)
_next_id = 0
_spans: List[Span] = []
_open: List[Span] = []


def span(name: str, **attrs):
    """A context manager for one span of ``name``: a recorded :class:`Span`
    while tracing is on, else the shared no-op ``OFF``."""
    if not _on:
        return OFF
    global _next_id
    _next_id += 1
    return Span(name, _next_id, 0, 0, 0, attrs=attrs)


def enable() -> None:
    """Turn tracing on, anchoring ``perf_counter_ns`` to ``time_ns`` now."""
    global _on, _anchor
    _anchor = (time.perf_counter_ns(), time.time_ns())
    _on = True


def disable() -> None:
    """Turn tracing off; spans recorded so far wait for :func:`drain`."""
    global _on
    _on = False


def drain() -> List[Span]:
    """The spans recorded since the last drain, their times on ``time_ns``;
    the list is emptied.  Spans still open are left out."""
    perf, unix = _anchor
    out = [s for s in _spans if s.end]
    for s in out:
        s.start += unix - perf
        s.end += unix - perf
    _spans[:] = [s for s in _spans if not s.end]
    return out
