#!/usr/bin/env python3
"""The lockstep solvers' three kernels at their launch shapes: a hash of
their output bits, so that two trees' kernels can be held to the same bits,
and their device time; ``--latency`` for the SM cycles of the port chain's
dependent steps; ``--census`` for the ordered scan's launches in the
cluster phase.

The ordered scan (both entries, ``ordered_scan`` and ``ordered_total``) runs
at ``chip_smoke.ORDERED_SCAN_PATHS``, the cluster phase's path shapes: one
line a shape with the output's SHA-1, device ms of the kernel alone
(torch.profiler) and by CUDA events queued behind ``torch.cuda._sleep``
(``chip_smoke.queued_ms``).  ``--census`` runs the phase's engaged rows on
the card in a process of its own, counts every ordered-scan call by call
site, entry and shape, then times each shape that way on fresh data: one
line a site and shape, and the phase's total device time.

The port chain's and numpy sum's shapes are the launches the tiered solver
gives at 4,096 devices on fat_tree (16 a node): all_to_all's dependency levels of 256 ports x 65,280 touches,
130 x 130,048 (the widest), 512 x 32,648 and 7,682 ports of 1-4,088 touches,
and for ``numpy_sum`` also one 65,280-element chunk and 8,194 segments of
1-8,193 elements and 65,280 (a flush's many short vectors).  One JSON line a
shape and kernel: a SHA-1 of the outputs' bytes, and device ms per launch by
CUDA events around each launch (``chip_smoke.launch_ms``).  The timing
helpers are ``chip_smoke.py``'s, which also times both kernels at the level
and the widest launch beside the library call; this script adds the other
launch shapes and ``--src``, which imports the package from another tree
(the parent's, which builds its kernels under its own ``build/``).

``--latency`` measures, on one thread by ``clock64``, the SM cycles a step
of the dependent chains the port chain is made of: a float64 add, a compare
and select, fmax, the kernel's step (compare, select, and the queued add
beside it), the step with fmax, the step with the add after the select, and
(for the issue rate) eight independent adds; each over 8 x 4,096 steps.
Needs a CUDA device; run from the repository root:
    python3 tools/tiered_kernels.py [--src build/parent/src] [--latency | --census]
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (ports, touches a port); None: 7,682 ports of 1 to 4,088 touches
CHAIN_SHAPES = ((256, 65_280), (130, 130_048), (512, 32_648), (7_682, None))
SUM_SHAPES = ((1, 65_280), (256, 65_280), (130, 130_048), (7_682, None), ("flush", None))


def _digest(*ts: torch.Tensor) -> str:
    h = hashlib.sha1()
    for t in ts:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _lengths(gen: torch.Generator, S, k) -> torch.Tensor:
    if S == "flush":
        return torch.tensor([*range(1, 8_194), 65_280])
    if k is None:
        return torch.randint(1, 4_089, (S,), generator=gen, device="cuda").cpu()
    return torch.full((S,), k)


def _offsets(lens: torch.Tensor) -> torch.Tensor:
    offs = torch.zeros(len(lens) + 1, dtype=torch.int64)
    torch.cumsum(lens, 0, out=offs[1:])
    return offs.cuda()


def chain_lines(gen: torch.Generator, src: str) -> list:
    import chip_smoke as cs
    from repro_torch.kernels.port_chain import port_chain_cuda

    lines = []
    for S, k in CHAIN_SHAPES:
        lens = _lengths(gen, S, k)
        offs = _offsets(lens)
        T, longest = int(lens.sum()), int(lens.max())
        ser = 0.5 + torch.rand(S, generator=gen, device="cuda", dtype=torch.float64)
        # arrivals in queue order, a little faster than the port drains them
        rdy = torch.rand(T, generator=gen, device="cuda", dtype=torch.float64)
        seg = torch.repeat_interleave(torch.arange(S, device="cuda"), lens.cuda())
        rdy = torch.sort(rdy + seg.to(torch.float64)).values - seg.to(torch.float64)
        rdy = rdy * (0.9 * lens.cuda().to(torch.float64) * ser)[seg]
        port = torch.randperm(4 * S, generator=gen, device="cuda")[:S]
        busy = torch.rand(4 * S, generator=gen, device="cuda", dtype=torch.float64)
        qd = torch.rand(4 * S, generator=gen, device="cuda", dtype=torch.float64)
        starts = port_chain_cuda(rdy, offs, port, ser, busy, qd)
        digest = _digest(starts, busy, qd)
        call = lambda: port_chain_cuda(rdy, offs, port, ser, busy, qd)  # noqa: E731
        ms = cs.launch_ms(call, iters=10)
        mhz = cs._sm_clock_under_load(call)
        lines.append({"kernel": "port_chain", "shape": [S, k or f"1-{longest}"],
                      "touches": T, "longest": longest, "device_ms": ms,
                      "device_ms_by": "CUDA events around each launch",
                      "ns_per_touch": ms * 1e6 / longest, "sm_clock_mhz": mhz,
                      "cycles_per_touch": ms * 1e3 * mhz / longest,
                      "bits_sha1": digest, "src": src})
    return lines


def sum_lines(gen: torch.Generator, src: str) -> list:
    import chip_smoke as cs
    from repro_torch.kernels.numpy_sum import numpy_sum_cuda

    lines = []
    for S, k in SUM_SHAPES:
        lens = _lengths(gen, S, k)
        offs = _offsets(lens)
        x = torch.rand(int(lens.sum()), generator=gen, device="cuda", dtype=torch.float64)
        x *= 10.0 ** torch.randint(-4, 4, x.shape, generator=gen, device="cuda")
        call = lambda: numpy_sum_cuda(x, offs)  # noqa: E731
        lines.append({"kernel": "numpy_sum", "shape": [len(lens), k or f"1-{int(lens.max())}"],
                      "elements": x.numel(), "device_ms": cs.launch_ms(call, iters=20),
                      "device_ms_by": "CUDA events around each launch",
                      "bits_sha1": _digest(call()), "src": src})
    return lines


def scan_lines(gen: torch.Generator, src: str) -> list:
    """The ordered scan at the cluster phase's path shapes
    (``chip_smoke.ORDERED_SCAN_PATHS``): a hash of each entry's output bits,
    device ms of the kernel alone (torch.profiler; cold over 3 copies of x
    where the solver reads x cold) and by events queued behind
    ``torch.cuda._sleep``.  A tree without ``ordered_total`` (the parent's)
    takes the scan's last row in its place: the same bits, the whole scan's
    time."""
    import itertools

    import chip_smoke as cs
    from repro_torch.kernels import ordered_scan as mod

    lines = []
    for entry, L, R, cold in cs.ORDERED_SCAN_PATHS:
        x = cs._ordered_scan_x(gen, L, R)
        fn = getattr(mod, f"{entry}_cuda", None)
        if fn is None:
            fn = lambda xx: mod.ordered_scan_cuda(xx)[-1]  # noqa: E731
        copies = [x, x.clone(), x.clone()] if cold else [x]
        turn = itertools.cycle(copies)
        prof = cs._profile_calls({"ordered_scan": fn}, copies)
        lines.append({"kernel": "ordered_scan", "entry": entry, "shape": [L, R],
                      "read": "cold" if cold else "warm", "device_ms": prof["ordered_scan"],
                      "device_ms_by": "torch.profiler, kernel alone",
                      "queued_ms": cs.queued_ms(lambda: fn(next(turn)), iters=5),
                      "bits_sha1": _digest(fn(x)), "src": src})
        del x, copies
    return lines


def _census_job(src: str) -> list:
    """The cluster phase's engaged rows on the card (chip_smoke's rows and
    warm-up), each ordered-scan call counted by call site, entry and shape:
    ``[[site, entry, L, R, calls], ...]`` and the rows' wall."""
    import time

    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import lockstep, lockstep_tiered

    calls = collections.Counter()

    def recording(fn, entry):
        def call(x):
            f = sys._getframe(1)
            calls[f"{Path(f.f_code.co_filename).name}:{f.f_lineno}", entry, *x.shape] += 1
            return fn(x)
        return call

    for mod in (lockstep, lockstep_tiered):
        for entry in ("ordered_scan", "ordered_total"):
            if hasattr(mod, entry):
                setattr(mod, entry, recording(getattr(mod, entry), entry))
    rows = cs._cluster_rows()
    cs._cluster_run(rows[0], "cuda")  # the cluster phase's warm-up, outside the count
    cs._cluster_run(next(r for r in rows if r["devices_per_node"] is not None
                         and r["lockstep_reason"] == "engaged"), "cuda")
    calls.clear()
    t0 = time.perf_counter()
    for row in rows:
        if row["lockstep_reason"] == "engaged":
            cs._cluster_run(row, "cuda")
    return [[*key, n] for key, n in sorted(calls.items())], time.perf_counter() - t0


def census_lines(gen: torch.Generator, src: str) -> list:
    """The ordered scan's launches in the cluster phase's card rows, by call
    site, entry and shape (counted in a process of its own), and each
    shape's device time (``chip_smoke.queued_ms``) on fresh data: one line a site and
    shape, then the phase's total."""
    import chip_smoke as cs
    from repro_torch.kernels import ordered_scan as mod

    sites, wall = cs.in_spawned_process(_census_job, src)
    lines, ms_of = [], {}
    for site, entry, L, R, n in sites:
        if (entry, L, R) not in ms_of:
            x = torch.randn(L, R, generator=gen, device="cuda", dtype=torch.float64)
            fn = getattr(mod, f"{entry}_cuda")
            ms_of[entry, L, R] = cs.queued_ms(lambda: fn(x))
            del x
        lines.append({"kernel": "ordered_scan", "census": site, "entry": entry, "shape": [L, R],
                      "launches": n, "device_ms": ms_of[entry, L, R], "src": src})
    lines.append({"kernel": "ordered_scan", "census": "cluster phase, engaged rows",
                  "launches": sum(s[-1] for s in sites), "shapes": len(ms_of),
                  "device_ms": sum(s[-1] * ms_of[tuple(s[1:4])] for s in sites),
                  "device_ms_by": "CUDA events around each launch behind torch.cuda._sleep, "
                                  "median of 3",
                  "rows_wall_s": wall, "src": src})
    return lines


LATENCY_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// One thread: the cycles of n x 8 dependent steps of each chain.
__global__ void chains(const double* r, double s, long long* cycles, double* sink, int n) {
  double rv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rv[i] = r[i];
  double b = r[8], q = r[9];
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) b = __dadd_rn(b, s);
  }
  long long t1 = clock64();
  cycles[0] = t1 - t0; sink[0] = b; b = r[8];
  t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) b = rv[k] > b ? rv[k] : b;
  }
  t1 = clock64();
  cycles[1] = t1 - t0; sink[1] = b; b = r[8];
  t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) b = fmax(rv[k], b);
  }
  t1 = clock64();
  cycles[2] = t1 - t0; sink[2] = b; b = r[8];
  t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // the kernel's step
      const bool later = rv[k] > b;
      const double st = later ? rv[k] : b;
      const double rs = __dadd_rn(rv[k], s), bs = __dadd_rn(b, s);
      q = __dadd_rn(q, __dsub_rn(st, rv[k]));
      b = later ? rs : bs;
    }
  }
  t1 = clock64();
  cycles[3] = t1 - t0; sink[3] = b + q; b = r[8]; q = r[9];
  t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // the step with fmax
      const double st = fmax(rv[k], b);
      q = __dadd_rn(q, __dsub_rn(st, rv[k]));
      b = __dadd_rn(st, s);
    }
  }
  t1 = clock64();
  cycles[4] = t1 - t0; sink[4] = b + q; b = r[8]; q = r[9];
  t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // the step with the add after the select
      const double st = rv[k] > b ? rv[k] : b;
      q = __dadd_rn(q, __dsub_rn(st, rv[k]));
      b = __dadd_rn(st, s);
    }
  }
  t1 = clock64();
  cycles[5] = t1 - t0; sink[5] = b + q;
  double acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = rv[k];
  t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = __dadd_rn(acc[k], s);  // 8 independent chains
  }
  t1 = clock64();
  cycles[6] = t1 - t0;
  sink[6] = acc[0] + acc[1] + acc[2] + acc[3] + acc[4] + acc[5] + acc[6] + acc[7];
}

extern "C" int chains_launch(const void* r, double s, void* cycles, void* sink, int n) {
  chains<<<1, 1>>>(static_cast<const double*>(r), s, static_cast<long long*>(cycles),
                   static_cast<double*>(sink), n);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""
CHAINS = ("dadd", "compare_select", "fmax", "kernel_step", "fmax_step", "select_add_step",
          "dadd_8_independent")


def latency_line(src: str) -> dict:
    """SM cycles a step of each chain in ``LATENCY_SOURCE``, built here."""
    from repro_torch.kernels import build

    out_dir = ROOT / "build" / "latency"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / "chains.cu", out_dir / "chains.so"
    cu.write_text(LATENCY_SOURCE)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).chains_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    r = torch.tensor([1.0, 9.0, 2.0, 7.0, 3.0, 8.0, 4.0, 6.0, 0.5, 0.25],
                     dtype=torch.float64, device="cuda")
    cycles = torch.zeros(len(CHAINS), dtype=torch.int64, device="cuda")
    sink = torch.zeros(len(CHAINS), dtype=torch.float64, device="cuda")
    n = 4096
    for _ in range(2):  # the second run's counts: the code is warm
        if fn(r.data_ptr(), 0.75, cycles.data_ptr(), sink.data_ptr(), n) != 0:
            raise RuntimeError("the latency kernel failed")
    return {"cycles_per_step": dict(zip(CHAINS, (cycles.cpu() / (8 * n)).tolist())),
            "steps": 8 * n, "src": src}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--latency", action="store_true")
    ap.add_argument("--census", action="store_true",
                    help="the cluster phase's ordered-scan launches and their device time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    scan_gen = torch.Generator(device="cuda").manual_seed(1)
    if args.census:
        for line in census_lines(scan_gen, args.src):
            print(json.dumps({**line, "card": card}), flush=True)
        return
    # the ordered scan's profiles first, in a process that has run nothing else
    lines = scan_lines(scan_gen, args.src) + chain_lines(gen, args.src) + sum_lines(gen, args.src)
    for line in lines:
        print(json.dumps({**line, "card": card}), flush=True)
    if args.latency:
        print(json.dumps({**latency_line(args.src), "card": card}), flush=True)


if __name__ == "__main__":
    main()
