"""EidolaSan: static verification and runtime sanitization of scenarios
(port of ``repro/analysis``: host code over Python ints, ``Fraction`` values and
numpy, copied whole; it touches no tensor).

Two halves that cross-check each other:

* :func:`verify_scenario` lowers a scenario's phase programs into an
  inter-rank wait/emit graph (:class:`ProgramGraph`) and checks it — deadlock
  cycles with full blame chains, unmatched synchronization, flag-slot write
  races, fabric reachability — in milliseconds, before any simulation.
* :class:`TrafficSanitizer` (enabled via ``Cluster(sanitize=True)`` or
  ``simulate(..., sanitize=True)``) shadows a closed-loop run and asserts
  byte conservation, calendar monotonicity, and exactly-once flag delivery.

A third leg quantifies over device counts instead of instances:
:func:`prove_layout` lowers a scenario's :class:`SymbolicProgram` +
:class:`AddressMap` into affine address families and proves flag/partial/
marker disjointness, unique flag writers, and wait/emit ordering for *all*
device counts up to the scenario's ``max_devices`` bound — without expanding
a single program (:mod:`repro_torch.analysis.layout`).

``python -m repro_torch.analysis`` verifies every registered scenario against every
fabric preset and runs the layout prover over the closed-loop registry (the
CI gate).
"""

from .layout import (
    LayoutFinding,
    LayoutProof,
    check_layout,
    check_programs,
    prove_layout,
    prove_registry,
)
from .program_graph import EmitSite, Lane, ProgramGraph, WaitSite
from .sanitize import SanitizerError, TrafficSanitizer
from .verify import (
    Finding,
    Verdict,
    diagnose_deadlock,
    verify_graph,
    verify_scenario,
)

__all__ = [
    "EmitSite",
    "Lane",
    "ProgramGraph",
    "WaitSite",
    "SanitizerError",
    "TrafficSanitizer",
    "Finding",
    "Verdict",
    "LayoutFinding",
    "LayoutProof",
    "check_layout",
    "check_programs",
    "prove_layout",
    "prove_registry",
    "diagnose_deadlock",
    "verify_graph",
    "verify_scenario",
]
