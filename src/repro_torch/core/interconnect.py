"""Hardware presets the roofline and the collective algebra price against
(port of ``HardwareSpec`` and ``V5E`` in ``repro/core/interconnect.py``).

:class:`HardwareSpec` and :data:`V5E` are copies of the reference's (the TPU
v5e constants its roofline is written for).  :data:`H100_SXM` is the port's
own preset, one NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU
data sheet (SXM5 column):

- ``peak_flops_bf16`` 989 TFLOP/s: BF16 Tensor Core, dense (the sheet's
  1,979 is with sparsity);
- ``hbm_bw`` 3.35 TB/s and ``hbm_bytes`` 80 GB (HBM3; taken as GiB, as
  ``V5E``'s 16 is);
- the intra-node tier (the ``ici_*`` fields) is NVLink 4: 900 GB/s a GPU,
  18 links of 25 GB/s in each direction, all of which a ring through the
  NVSwitches can use (``ici_links_per_axis`` 18), in an 8-GPU HGX/DGX node;
- the inter-node tier (the ``dci_*`` fields) is NDR InfiniBand, 400 Gb/s:
  one ConnectX-7 a GPU in a DGX H100, 50 GB/s in each direction.

The sheet gives no hop latency: ``ici_hop_latency_s`` (1 µs) and
``dci_hop_latency_s`` (5 µs) are assumptions, not measurements.  ``vmem_bytes``
(the TPU's VMEM) has no H100 counterpart; the port puts the 228 KB of shared
memory an SM has there, and nothing in the port reads the field.
``dci_name`` (the port's addition) names the inter-node tier in
``Topology.describe``.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["HardwareSpec", "V5E", "H100_SXM", "HARDWARE", "NVLINK_NODE_GPUS"]


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12     # per chip
    hbm_bw: float = 819e9               # bytes/s per chip
    ici_link_bw: float = 50e9           # bytes/s per link per direction
    ici_links_per_axis: int = 1         # links a ring along one axis can use
    ici_hop_latency_s: float = 1e-6
    dci_link_bw: float = 12.5e9         # inter-pod (pod axis) bandwidth
    dci_hop_latency_s: float = 10e-6
    vmem_bytes: int = 128 * 1024 * 1024
    hbm_bytes: int = 16 * 1024**3
    dci_name: str = "DCI"


V5E = HardwareSpec()

H100_SXM = HardwareSpec(
    name="h100-sxm5",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_link_bw=25e9,
    ici_links_per_axis=18,
    ici_hop_latency_s=1e-6,      # assumption: the data sheet gives none
    dci_link_bw=50e9,
    dci_hop_latency_s=5e-6,      # assumption: the data sheet gives none
    vmem_bytes=228 * 1024,       # shared memory an SM; read by nothing
    hbm_bytes=80 * 1024**3,
    dci_name="IB",
)

NVLINK_NODE_GPUS = 8  # GPUs an HGX / DGX H100 node joins over NVLink

HARDWARE = {"h100": H100_SXM, "v5e": V5E}
