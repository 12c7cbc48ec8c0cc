"""The Eidola model's pieces the port needs (port of parts of ``repro.core``).

``replay_lane`` and ``spin_reads`` are the spin-wait closed forms of the
GEMV+AllReduce's ``wait_flags`` phase, vectorised over cohorts or
workgroups on a torch device.  The capture bridge's modules copy what it
needs of the numpy simulator's: ``interconnect`` (the hardware presets,
``H100_SXM`` the port's own), ``topology`` (the collective algebra),
``events`` and ``memory`` (the trace and its address map), ``capture`` (the
torch front end and the trace lowering), ``cost`` (a traced step's FLOPs and
bytes) and ``predictor`` (the roofline).  The simulator's engines are not
ported: a trace the port writes is replayed by ``repro.core.Eidola``.
"""

from .cohort_timeline import replay_lane
from .vector_engine import spin_reads

__all__ = ["replay_lane", "spin_reads"]
