#!/usr/bin/env python3
"""gemma3-1b's serve and train phases of ``chip_smoke.py``, from two trees in turns.

Compares two checkouts (say a parent commit and its change) on one card.
Each turn is a process of its own that imports the given tree's
``chip_smoke.py`` and ``src/``, builds that tree's kernels
(``phase_build``), then runs its ``phase_serve`` and ``phase_train`` for
gemma3-1b at full width, exactly as the script's own run does: 4 requests of
480 + 64 tokens, and 8 steps at B 4 x S 1024 in 2 microbatches.  The turns
go A, B, B, A (``--rounds`` times), so a drift of the host over the call
falls on both trees alike.  One JSON line a turn, then a summary line with
each tree's medians:

- ``serve_ms_per_step``: wall ms a decode step of the served run;
- ``train_ms_per_step``: median wall ms of steps 2-8;
- ``train_device_busy_ms``: device busy ms of one profiled train step;
- ``seconds``: the turn's wall, process start and kernel build included.

Needs a CUDA device; run from the repository root, with the other tree
unpacked somewhere (``git archive``):
    python3 tools/serve_train_ab.py PARENT_ROOT CHANGE_ROOT [--rounds 1]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ARCH = "gemma3-1b"


def child(root: str) -> None:
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    smoke.phase_build()
    model, serve = smoke.phase_serve(card, ARCH)
    del model
    torch.cuda.empty_cache()
    train = smoke.phase_train(card, ARCH)
    print(json.dumps({"serve_ms_per_step": serve["ms_per_step"],
                      "serve_wall_s": serve["wall_s"],
                      "train_ms_per_step": train["ms_per_step_median_2_on"],
                      "train_step_ms": train["step_ms"],
                      "train_device_busy_ms": train["profile"]["device_busy_ms"],
                      "card": card}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.a)
        return
    runs = {args.a: [], args.b: []}
    for root in (args.a, args.b, args.b, args.a) * args.rounds:
        t0 = time.perf_counter()
        done = subprocess.run([sys.executable, os.path.abspath(__file__), root, root, "--child"],
                              capture_output=True, text=True)
        if done.returncode != 0:
            sys.stderr.write(done.stdout[-4000:] + done.stderr[-8000:])
            raise SystemExit(f"turn on {root} exited {done.returncode}")
        line = json.loads(done.stdout.strip().splitlines()[-1])
        line.update(tree=root, seconds=time.perf_counter() - t0)
        runs[root].append(line)
        print(json.dumps(line), flush=True)
    keys = ("serve_ms_per_step", "train_ms_per_step", "train_device_busy_ms", "seconds")
    print(json.dumps({"summary": {root: {k: statistics.median(r[k] for r in turns)
                                         for k in keys} for root, turns in runs.items()},
                      "order": [args.a, args.b, args.b, args.a] * args.rounds}))


if __name__ == "__main__":
    main()
