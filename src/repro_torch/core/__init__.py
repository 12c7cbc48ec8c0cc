"""The Eidola model's two scans (port of the JAX code in ``repro.core``).

``replay_lane`` and ``spin_reads`` are the spin-wait closed forms of the
GEMV+AllReduce's ``wait_flags`` phase, vectorised over cohorts or
workgroups on a torch device.  Nothing else of the numpy simulator is ported.
"""

from .cohort_timeline import replay_lane
from .vector_engine import spin_reads

__all__ = ["replay_lane", "spin_reads"]
