"""Built-in Eidola traffic scenarios (port of ``repro/core/scenarios``).

Importing this package registers every built-in with the port's scenario
registry (:mod:`repro_torch.core.scenario`):

* ``gemv_allreduce`` — the paper's fused GEMV+AllReduce kernel (Table 1).
* ``ring_allreduce`` — chunked ring all-reduce; one wait/flag per ring step,
  arrival schedule synthesized from the collective cost model in
  :mod:`repro_torch.core.topology`.
* ``all_to_all``     — MoE-dispatch-shaped incast: every peer pushes a token
  shard and a completion flag; the target barriers on all of them.
* ``pipeline_p2p``   — pipeline-parallel stage: per-microbatch activation
  wait -> forward compute -> p2p send to the next stage.
* ``hierarchical_allreduce`` — closed-loop cross-tier collective: intra-node
  ring reduce-scatter (ICI), leader ring all-reduce over the DCI uplinks,
  intra-node broadcast.

All but ``gemv_allreduce`` also run closed loop (``closed_loop=True``).
"""

from .all_to_all import AllToAllScenario
from .gemv_allreduce import GemvAllReduceScenario
from .hierarchical_allreduce import HierarchicalAllReduceScenario
from .pipeline_p2p import PipelineP2PScenario
from .ring_allreduce import RingAllReduceScenario

__all__ = [
    "AllToAllScenario",
    "GemvAllReduceScenario",
    "HierarchicalAllReduceScenario",
    "PipelineP2PScenario",
    "RingAllReduceScenario",
]
