"""Fault tolerance of the port: what the trainer uses (port of part of ``repro.ft``)."""

from .resilience import SimulatedFailure, StragglerMonitor, StragglerReport

__all__ = ["SimulatedFailure", "StragglerMonitor", "StragglerReport"]
