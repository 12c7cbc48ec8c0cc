"""Published peaks of the cards the benchmark reads rooflines against, by the
name ``torch.cuda.get_device_name()`` gives: dense rates without sparsity,
at the card's full power limit (each run prints the limit it found).

NVIDIA H100 SXM data sheet: 989 TFLOP/s in bfloat16, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str, what: str) -> Optional[float]:
    """The card's published ``bf16_flops`` or ``hbm_bytes_per_s``; None for
    a card that the table does not hold."""
    return PEAKS.get(kind, {}).get(what)


def bound_s(kind: str, flops: float, nbytes: float) -> Optional[float]:
    """The least time the card could take for this work: the larger of its
    operations over the peak rate and its bytes over the peak bandwidth."""
    f, b = peak(kind, "bf16_flops"), peak(kind, "hbm_bytes_per_s")
    if f is None or b is None:
        return None
    return max(flops / f, nbytes / b)
