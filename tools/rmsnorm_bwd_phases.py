#!/usr/bin/env python3
"""Where a launch of the rmsnorm backward spends its time, CTA by CTA, on the card.

Builds a copy of ``csrc/rmsnorm.cu`` with a timestamp (``%globaltimer``)
taken by thread 0 of every CTA at the kernel's phase boundaries, and the SM
it ran on, launches it through the port's wrapper on seeded bf16 operands at
the training paths' shapes, and prints one JSON line a shape: when the CTAs
started (median and latest, µs from the first start), how many SMs they ran
on, each phase's median and longest over CTAs, and the end of the last CTA.
The reducers' ticket phase includes their wait for the
last CTA.  ``--src`` takes the package from
another tree.  The copy and its library go to ``build/phases/`` (gitignored);
the kernel itself is untouched.  Run from the repository root on a machine
with a CUDA device:
    python3 tools/rmsnorm_bwd_phases.py [--src DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2048, 1152), (1024, 1152), (1024, 768))
SLOTS = 4  # timestamps a CTA, then its SM id
MAX_CTAS = 4096
# (marker in the source, timestamp index, insert before the marker?)
MARKS = [
    ("  const int64_t row1 = row0 + rows_per_cta < rows ? row0 + rows_per_cta : rows;\n", 0,
     False),
    ("  // dgamma: this CTA's column sums to its workspace row, then a ticket\n", 1, True),
    ("  if (reducer < 0) return;\n", 2, True),
]
END = "    __syncthreads();  // fin is read before the next pass writes it\n  }\n"  # the reducers' end
PHASES = {"rows": (0, 1), "workspace_row_and_ticket": (1, 2), "reduce": (2, 3)}


def _stamp(k: int) -> str:
    return (f"  if (threadIdx.x == 0 && blockIdx.x < {MAX_CTAS}) {{ unsigned long long t_; "
            f"asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
            f"stamp_ns[blockIdx.x][{k}] = t_; unsigned s_; "
            f"asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s_)); "
            f"stamp_ns[blockIdx.x][{SLOTS}] = s_; }}\n")


def build_instrumented(build) -> ctypes.CDLL:
    src = (build.CSRC / "rmsnorm.cu").read_text()
    head = "using namespace repro_torch;\n"
    src = src.replace(head, head + (
        f"__device__ unsigned long long stamp_ns[{MAX_CTAS}][{SLOTS + 1}];\n"
        "extern \"C\" int stamps_read(void* ns) {\n"
        "  return cudaMemcpyFromSymbol(ns, stamp_ns, sizeof(stamp_ns));\n"
        "}\n"
        "extern \"C\" int stamps_clear(void* zeros) {\n"
        "  return cudaMemcpyToSymbol(stamp_ns, zeros, sizeof(stamp_ns));\n"
        "}\n"), 1)
    for marker, k, before in MARKS:
        if src.count(marker) != 1:
            raise RuntimeError(f"marker for timestamp {k} not found once in the source: {marker!r}")
        src = src.replace(marker, _stamp(k) + marker if before else marker + _stamp(k))
    if src.count(END) != 1:
        raise RuntimeError("the kernel's last lines not found once in the source")
    src = src.replace(END, END + _stamp(3))
    out = build.BUILD_DIR.parent / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "rmsnorm.cu").write_text(src)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                    str(out / "rmsnorm.so"), str(out / "rmsnorm.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out / "rmsnorm.so"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_bwd_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    rm = importlib.import_module("repro_torch.kernels.rmsnorm")
    build = importlib.import_module("repro_torch.kernels.build")
    lib = build_instrumented(build)
    fn = lib.rmsnorm_bwd_launch
    fn.argtypes = rm._bwd_launch_fn().argtypes
    fn.restype = ctypes.c_int
    rm._bwd_launch_fn = lambda: fn  # the wrapper launches the instrumented copy
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    ns = np.zeros((MAX_CTAS, SLOTS + 1), np.uint64)
    zeros = np.zeros_like(ns)
    for rows, d in SHAPES:
        x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
        g = (torch.randn(d, generator=gen, device="cuda") * 0.2).to(torch.bfloat16)
        dy = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
        plan = rm.rmsnorm_bwd_plan(rows, d, 2, sms)
        for _ in range(6):  # the last of six launches is read
            torch.cuda.synchronize()
            lib.stamps_clear(zeros.ctypes.data)
            rm.rmsnorm_bwd_cuda(x, g, dy, plan=plan)
            torch.cuda.synchronize()
            lib.stamps_read(ns.ctypes.data)
        t = ns[:plan.ctas, :SLOTS].astype(np.int64)
        rel = (t - t[:, 0].min()) / 1e3
        last = np.where(t[:, 3] > 0, t[:, 3], t[:, 2])
        row = {"shape": [rows, d], "plan": plan.__dict__, "card": card,
               "sms_used": int(len(set(ns[:plan.ctas, SLOTS].tolist()))),
               "start": [float(np.median(rel[:, 0])), float(rel[:, 0].max())],
               "end": float((last.max() - t[:, 0].min()) / 1e3),
               "rows_end": [float(np.median(rel[:, 1])), float(rel[:, 1].max())]}
        for name, (a, b) in PHASES.items():
            ok = (t[:, a] > 0) & (t[:, b] > 0)
            if ok.any():
                dd = rel[ok, b] - rel[ok, a]
                row[name] = [float(np.median(dd)), float(dd.max())]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
