#!/usr/bin/env python3
"""Device time of each launch of the rmsnorm backward, beside F.rms_norm's.

At the training paths' shapes (bf16 x, g, dy [rows, D]: gemma3-1b's
microbatch [2048, 1152], a rank of its sharded step [1024, 1152], xlstm-125m's
batch [1024, 768]) it profiles ``reps`` calls of ``rmsnorm_bwd_cuda`` and as
many of the autograd backward of ``F.rms_norm`` (weight 1 + gamma), in turns,
and prints one JSON line a shape: every device row of each side (kernel name,
launches a call, µs a launch and a call), and µs a call by CUDA events over
200 calls.  ``--plans`` also profiles the kernel under other plans: every block of
rows a thread can hold, one, two and four blocks a CTA.  ``--src`` imports the package
from another tree (the parent's, to split its launches before a change),
which builds its kernels under its own ``build/``.  Needs a CUDA device; run from the repository root:
    python3 tools/rmsnorm_bwd_launches.py [--src build/parent/src] [--reps 50] [--plans]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2048, 1152), (1024, 1152), (1024, 768))


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0))


def _rows(prof, reps: int) -> list:
    out = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            name = evt.key.replace("(anonymous namespace)::", "").split("(")[0]
            out.append({"kernel": name[:120], "launches_per_call": evt.count / reps,
                        "us_per_launch": us / evt.count, "us_per_call": us / reps})
    return sorted(out, key=lambda r: -r["us_per_call"])


def _events_us(fn, n: int = 200) -> float:
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, d in SHAPES:
        x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
        g = (torch.randn(d, generator=gen, device="cuda") * 0.2).to(torch.bfloat16)
        dy = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
        xr = x.clone().requires_grad_(True)
        wr = (1.0 + g.float()).to(torch.bfloat16).requires_grad_(True)
        y = F.rms_norm(xr, (d,), weight=wr, eps=1e-6)
        calls = {"kernel": lambda: rmsnorm_bwd_cuda(x, g, dy),
                 "library": lambda: torch.autograd.grad(y, (xr, wr), dy, retain_graph=True)}
        line = {"shape": [rows, d], "dtype": "bfloat16", "src": args.src, "card": card}
        if args.plans:
            import dataclasses

            from repro_torch.kernels.gemv import sm_count
            from repro_torch.kernels.rmsnorm import (BWD_BLOCK_VECTORS, BWD_BLOCKS,
                                                     rmsnorm_bwd_plan)

            base = rmsnorm_bwd_plan(rows, d, 2, sm_count(x.device))
            for block in (b for b in BWD_BLOCKS if b * base.nv <= BWD_BLOCK_VECTORS or b == 1):
                for per in (block, 2 * block, 4 * block):
                    ctas = -(-rows // per)
                    plan = dataclasses.replace(base, ctas=ctas, rows_per_cta=per, block=block)
                    calls[f"kernel_block{block}_rows{per}_ctas{ctas}"] = (
                        lambda p=plan: rmsnorm_bwd_cuda(x, g, dy, plan=p))
        for name, fn in calls.items():
            fn()  # builds, allocates
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(args.reps):
                    fn()
                torch.cuda.synchronize()
            line[name] = {"device_rows": _rows(prof, args.reps), "events_us": _events_us(fn)}
        print(json.dumps(line))


if __name__ == "__main__":
    main()
