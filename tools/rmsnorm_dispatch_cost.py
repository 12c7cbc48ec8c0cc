#!/usr/bin/env python3
"""Host cost of reaching the rmsnorm kernels through custom operators.

The route this tool measures is the one the package does not take: the
kernels as ``torch.library.custom_op`` operators with a CUDA body and
``register_autograd``, as the dry run's shape functions would have been if
they also launched.  The tool defines those operators itself (namespace
``rmsnorm_dispatch_cost``; the package's ``repro_torch::rmsnorm`` /
``rmsnorm_bwd`` are shape functions for ``meta`` tensors only and raise on
the card), and holds them against the "direct" route,
``kernels.ops.rmsnorm`` (the ctypes wrapper ``rmsnorm_cuda``, and
``RMSNormFunction`` under autograd).  In one process, in turns (direct,
operator, operator, direct, twice), it prints one JSON line with:

- host µs a call of each route at gemma3-1b's decode shape [4, 1, 1152]
  bf16 (no grad; 2,000 calls, then one synchronize) and a forward plus
  backward at a sharded rank's training shape [1024, 1152];
- gemma3-1b at full width (random bf16 weights, seed 0): ms a decode step of
  ``Model.decode_step`` at batch 4 against a 544-slot cache (64 steps a
  turn after a 480-token prefill), with ``ops.rmsnorm`` set to each route.

Needs a CUDA device; run from the repository root:
    python3 tools/rmsnorm_dispatch_cost.py [--steps 64] [--calls 2000]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda  # noqa: E402
from repro_torch.models import Model  # noqa: E402


@torch.library.custom_op("rmsnorm_dispatch_cost::rmsnorm", mutates_args=())
def rmsnorm_op(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    return rmsnorm_cuda(x, gamma, eps)


@torch.library.custom_op("rmsnorm_dispatch_cost::rmsnorm_bwd", mutates_args=())
def rmsnorm_bwd_op(x: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor,
                   eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    return rmsnorm_bwd_cuda(x, gamma, g, eps)


def _save_inputs(ctx, inputs, output):
    x, gamma, eps = inputs
    ctx.save_for_backward(x, gamma)
    ctx.eps = eps


def _grads(ctx, g):
    x, gamma = ctx.saved_tensors
    dx, dgamma = rmsnorm_bwd_op(x, gamma, g.contiguous(), ctx.eps)
    return (dx if ctx.needs_input_grad[0] else None,
            dgamma if ctx.needs_input_grad[1] else None, None)


rmsnorm_op.register_autograd(_grads, setup_context=_save_inputs)


ORDER = ("direct", "operator", "operator", "direct") * 2
ROUTES = {"direct": ops.rmsnorm, "operator": rmsnorm_op}


def _host_us(fn, calls: int) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 1, 1152, device=dev, generator=gen).to(torch.bfloat16)
    g = (0.1 * torch.randn(1152, device=dev, generator=gen)).to(torch.bfloat16)
    xt = torch.randn(1024, 1152, device=dev, generator=gen).to(torch.bfloat16).requires_grad_()
    gt = g.clone().requires_grad_()
    dy = torch.randn(1024, 1152, device=dev, generator=gen).to(torch.bfloat16)

    out = {"decode_call_us": {k: [] for k in ROUTES}, "train_call_us": {k: [] for k in ROUTES}}
    with torch.no_grad():
        for route in ORDER:
            out["decode_call_us"][route].append(
                _host_us(lambda: ROUTES[route](x, g, 1e-6), args.calls))
    for route in ORDER:
        out["train_call_us"][route].append(
            _host_us(lambda: ROUTES[route](xt, gt, 1e-6).backward(dy), args.calls // 4))

    cfg = get_config("gemma3-1b")
    model = Model(cfg).init(gen)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab, (4, 544)))
    tokens = tokens.to(dev)
    caches = model.init_caches(4, 544)
    with torch.no_grad():
        for pos in range(480):  # fill the cache, one position a step
            model.decode_step(caches, tokens[:, pos], pos)
    out["decode_step_ms"] = {k: [] for k in ROUTES}
    plain = ops.rmsnorm
    try:
        for route in ORDER:
            ops.rmsnorm = ROUTES[route]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(args.steps):
                model.decode_step(caches, tokens[:, 480 + i], 480 + i)
            torch.cuda.synchronize()
            out["decode_step_ms"][route].append((time.perf_counter() - t0) * 1e3 / args.steps)
    finally:
        ops.rmsnorm = plain
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out.update(order=ORDER, steps=args.steps, calls=args.calls,
               rmsnorm_calls_per_decode_step=53, card=card.strip().splitlines()[0])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
