"""Built-in Eidola traffic scenarios (port of ``repro/core/scenarios``).

Importing this package registers every built-in with the port's scenario
registry (:mod:`repro_torch.core.scenario`):

* ``gemv_allreduce`` — the paper's fused GEMV+AllReduce kernel (Table 1).

The reference's closed-loop scenarios (``ring_allreduce``, ``all_to_all``,
``pipeline_p2p``, ``hierarchical_allreduce``) are not ported yet.
"""

from .gemv_allreduce import GemvAllReduceScenario

__all__ = ["GemvAllReduceScenario"]
