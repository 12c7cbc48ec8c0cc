"""Eidolon trace generators (port of ``repro/core/egpu.py``).

The paper feeds Eidola with (a) annotated timing profiles from real
applications and (b) "synthetically generated profiles from probabilistic
models" [8, 17, 27, 47].  This module provides the synthetic side: per-eGPU
stochastic write-stream generators, plus helpers to merge streams into a
:class:`TraceBundle`.  The GEMV+AllReduce application traces live in
``workload.make_gemv_allreduce_traces``; a torch program's captured
collectives in ``capture``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .events import TraceBundle
from .memory import AddressMap

__all__ = [
    "uniform_stream",
    "poisson_stream",
    "burst_stream",
    "periodic_stream",
    "merge_streams",
]


def _bundle_from(times_by_src: Dict[int, np.ndarray], amap: AddressMap,
                 meta: Optional[dict] = None) -> TraceBundle:
    bundle = TraceBundle(meta=meta or {})
    for src in sorted(times_by_src):
        for i, t in enumerate(np.sort(times_by_src[src])):
            addr = amap.partial_base + 64 * ((src * 65536 + i) % 4096)
            bundle.add(wakeup_ns=float(t), addr=addr, data=i, size=8, src=src)
        # every stream ends with the peer's flag write so waiting workloads
        # can terminate
        bundle.add(
            wakeup_ns=float(times_by_src[src].max(initial=0.0)),
            addr=amap.flag_addr(src),
            data=1,
            size=8,
            src=src,
        )
    return bundle


def uniform_stream(
    n_egpus: int,
    writes_per_egpu: int,
    span_ns: float,
    *,
    seed: int = 0,
    amap: Optional[AddressMap] = None,
) -> TraceBundle:
    """Writes uniformly distributed over [0, span_ns)."""
    amap = amap or AddressMap(n_devices=n_egpus + 1)
    rng = np.random.default_rng(seed)
    times = {
        g: rng.uniform(0.0, span_ns, size=writes_per_egpu)
        for g in range(1, n_egpus + 1)
    }
    return _bundle_from(times, amap, {"pattern": "uniform", "span_ns": span_ns})


def poisson_stream(
    n_egpus: int,
    rate_per_us: float,
    span_ns: float,
    *,
    seed: int = 0,
    amap: Optional[AddressMap] = None,
) -> TraceBundle:
    """Poisson arrivals with the given rate (writes per microsecond)."""
    amap = amap or AddressMap(n_devices=n_egpus + 1)
    rng = np.random.default_rng(seed)
    times: Dict[int, np.ndarray] = {}
    for g in range(1, n_egpus + 1):
        gaps = rng.exponential(1000.0 / rate_per_us, size=max(4, int(
            2 * rate_per_us * span_ns / 1000.0)))
        t = np.cumsum(gaps)
        times[g] = t[t < span_ns]
        if times[g].size == 0:
            times[g] = np.array([span_ns * 0.5])
    return _bundle_from(times, amap, {"pattern": "poisson", "rate_per_us": rate_per_us})


def burst_stream(
    n_egpus: int,
    bursts: int,
    writes_per_burst: int,
    span_ns: float,
    *,
    burst_width_ns: float = 200.0,
    seed: int = 0,
    amap: Optional[AddressMap] = None,
) -> TraceBundle:
    """Bursty producer-consumer traffic (the paper's asymmetric use case)."""
    amap = amap or AddressMap(n_devices=n_egpus + 1)
    rng = np.random.default_rng(seed)
    times: Dict[int, np.ndarray] = {}
    for g in range(1, n_egpus + 1):
        centers = rng.uniform(0.0, span_ns, size=bursts)
        t = (
            centers[:, None]
            + rng.normal(0.0, burst_width_ns, size=(bursts, writes_per_burst))
        ).ravel()
        times[g] = np.clip(t, 0.0, span_ns)
    return _bundle_from(times, amap, {"pattern": "burst"})


def periodic_stream(
    n_egpus: int,
    period_ns: float,
    span_ns: float,
    *,
    phase_ns: float = 0.0,
    amap: Optional[AddressMap] = None,
) -> TraceBundle:
    """Deterministic periodic writes (e.g. pipeline-parallel microbatches)."""
    amap = amap or AddressMap(n_devices=n_egpus + 1)
    times = {
        g: np.arange(phase_ns + (g - 1) * period_ns / n_egpus, span_ns, period_ns)
        for g in range(1, n_egpus + 1)
    }
    return _bundle_from(times, amap, {"pattern": "periodic", "period_ns": period_ns})


def merge_streams(*bundles: TraceBundle) -> TraceBundle:
    out = TraceBundle(meta={"pattern": "merged"})
    for b in bundles:
        out.extend(b)
    return out
