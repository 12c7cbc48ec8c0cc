"""The Eidola simulator and the capture bridge (port of ``repro.core``).

The open-loop simulator: one detailed device (``target``: phase programs as
data, SPIN and SyncMon waits, counted cohorts) replays its peers' registered
writes (``events``) from the write-tracking table (``wtt``) into a directory
memory with a Monitor Log (``memory``, ``monitor``), driven by the cycle or
event engine (``engine``) on the host or by the vector engine
(``vector_engine.run_vectorized``) on torch tensors on a device; ``simulator``
(``Eidola``, ``Report``) wires them, ``scenario`` is the program API, the
registry, ``simulate`` and ``SweepRunner``, ``scenarios`` registers
``gemv_allreduce`` (``workload``), ``perturb`` the variability models and
``trace_render`` the timeline exports.  ``simulate``, ``Eidola``,
``run_gemv_allreduce`` and ``SweepRunner`` run on the CUDA device unless the
caller passes ``device="cpu"``.

The closed loop: ``cluster`` (``Cluster``: every device detailed, flags
emitted at phase completions and routed over ``topology.FabricModel``, a
fabric from ``interconnect``'s gallery), the four closed-loop scenarios,
``cohort_timeline``'s ``TimelineEngine`` (host) and ``lockstep``'s flat
solver, whose cursor matrices live on the cluster's device; ``egpu`` holds
the synthetic write-stream generators.  ``Cluster`` runs on the CUDA device
unless the caller passes ``device="cpu"``.  ``lockstep_tiered`` solves the
group-uniform programs over the multi-tier presets on that device too, and
``verify_scenario`` (lazily re-exported) is :mod:`repro_torch.analysis`'s.

``replay_lane`` and ``spin_reads`` are the spin-wait closed forms vectorised
over cohorts or workgroups.  The capture bridge's modules: ``interconnect``
(the hardware presets, ``H100_SXM`` the port's own), ``topology`` (the
collective algebra), ``capture`` (the torch front end and the trace
lowering), ``cost`` (a traced step's FLOPs and bytes) and ``predictor`` (the
roofline).
"""

from .cluster import Cluster, ClusterNode
from .cohort_timeline import TimelineEngine, replay_lane
from .config import EngineKind, SimConfig, SyncPolicy
from .events import PHASES, RegisteredWrite, Segment, TraceBundle, register_phase
from .interconnect import (
    InterconnectSpec,
    Leg,
    LinkClass,
    RoutingPolicy,
    build_fabric,
    get_fabric,
    list_fabrics,
    register_fabric,
    resolve_fabric,
)
from .lockstep import LockstepEngine
from .memory import AddressMap, DirectoryMemory, TrafficCounters
from .monitor import MonitorEntry, MonitorLog
from .perturb import GaussianPerturb, NullPerturb, PeerDelayPerturb
from .scenario import (
    EmitOp,
    PhaseSpec,
    Scenario,
    SweepPoint,
    SweepRunner,
    TrafficOp,
    WGProgram,
    get_scenario,
    list_scenarios,
    register_scenario,
    simulate,
)
from .simulator import Eidola, Report, run_gemv_allreduce
from .target import EidolaDeadlock, TargetDevice
from .topology import FabricModel, HardwareSpec, Topology
from .vector_engine import spin_reads
from .workload import GemvAllReduceWorkload, make_gemv_allreduce_traces
from .wtt import WriteTrackingTable

__all__ = [
    "EngineKind", "SimConfig", "SyncPolicy",
    "PHASES", "RegisteredWrite", "Segment", "TraceBundle", "register_phase",
    "AddressMap", "DirectoryMemory", "TrafficCounters",
    "MonitorEntry", "MonitorLog",
    "GaussianPerturb", "NullPerturb", "PeerDelayPerturb",
    "EmitOp", "PhaseSpec", "Scenario", "SweepPoint", "SweepRunner",
    "TrafficOp", "WGProgram", "get_scenario", "list_scenarios",
    "register_scenario", "simulate",
    "Eidola", "Report", "run_gemv_allreduce",
    "EidolaDeadlock", "TargetDevice",
    "Cluster", "ClusterNode",
    "FabricModel", "HardwareSpec", "Topology",
    "InterconnectSpec", "LinkClass", "Leg", "RoutingPolicy",
    "build_fabric", "get_fabric", "list_fabrics", "register_fabric",
    "resolve_fabric",
    "LockstepEngine", "TimelineEngine",
    "GemvAllReduceWorkload", "make_gemv_allreduce_traces",
    "WriteTrackingTable",
    "replay_lane", "spin_reads",
    "verify_scenario",
]


def __getattr__(name):
    # PEP 562 lazy re-export: repro_torch.analysis imports
    # repro_torch.core.cluster, so a top-level import here would be circular
    if name == "verify_scenario":
        from ..analysis import verify_scenario

        return verify_scenario
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
