"""Fault tolerance of the port (port of ``repro.ft``)."""

from .resilience import (ElasticMeshManager, HeartbeatMonitor, SimulatedFailure,
                         StragglerMonitor, StragglerReport, remesh_pytree)

__all__ = ["SimulatedFailure", "HeartbeatMonitor", "StragglerMonitor", "StragglerReport",
           "ElasticMeshManager", "remesh_pytree"]
