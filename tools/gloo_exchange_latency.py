#!/usr/bin/env python3
"""What one exchange costs when ranks share the card through gloo.

Spawns 4 ranks (``run_world``) on ``cuda:0`` and times, per rank, a loop of
small all-reduces over all 4 (a decode step's tensor-parallel sum: [2, 1152]
float32, 9216 B) as the port exchanges them (``raw_all_reduce``: a copy to
the host, gloo, a copy back), each after one small kernel, in four modes:

- ``cuda``: the port's path, the kernel's tensor handed straight over;
- ``cuda_split``: the same, with ``torch.cuda.synchronize()`` first, timed
  apart: how long the rank waits for the card, and the exchange alone;
- ``cpu``: host tensors, no card (gloo's own floor);
- ``cuda_1_thread``: ``cuda`` with one intra-op thread a rank.

Prints one JSON line: each mode's mean ms an exchange on every rank, and the
card's name and power limit.  Run from the repository root on a machine with
a CUDA device:
    python3 tools/gloo_exchange_latency.py [--ops 200]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

WORLD = 4
SHAPE = (2, 1152)


def _rank(rank: int, world: int, ops: int) -> dict:
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.distributed.collectives import raw_all_reduce
    from repro_torch.launch.mesh import Mesh

    torch.cuda.set_device(0)
    mesh = Mesh({"data": 1, "model": world}).bind()
    out = {}
    for mode in ("cuda", "cuda_split", "cpu", "cuda_1_thread"):
        threads = torch.get_num_threads()
        if mode == "cuda_1_thread":
            torch.set_num_threads(1)
        x = torch.randn(SHAPE, device="cpu" if mode == "cpu" else "cuda")
        for _ in range(20):  # warm-up
            raw_all_reduce(x * 1.0001, mesh, "model")
        dist.barrier()
        waited = exchanged = 0.0
        t0 = time.perf_counter()
        for _ in range(ops):
            y = x * 1.0001
            if mode == "cuda_split":
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                raw_all_reduce(y, mesh, "model")
                waited += t2 - t1
                exchanged += time.perf_counter() - t2
            else:
                raw_all_reduce(y, mesh, "model")
        if mode != "cpu":
            torch.cuda.synchronize()
        out[mode] = (time.perf_counter() - t0) * 1e3 / ops
        if mode == "cuda_split":
            out["cuda_split_wait"] = waited * 1e3 / ops
            out["cuda_split_exchange"] = exchanged * 1e3 / ops
        torch.set_num_threads(threads)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_exchange_latency: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ops", type=int, default=200)
    args = ap.parse_args()
    from repro_torch.distributed import run_world

    ranks = run_world(_rank, WORLD, args.ops, timeout=600)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tool": "gloo_exchange_latency", "ranks": WORLD, "shape": list(SHAPE),
                      "ops": args.ops, "ms_per_exchange_by_rank": ranks, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
