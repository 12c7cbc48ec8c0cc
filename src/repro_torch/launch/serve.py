"""Batched-serving command line of the port: token-by-token prefill + decode.

Runs the full-width config on the CUDA device by default:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --requests 4 --prompt-len 480 --new-tokens 64
``--reduced`` takes the small CPU-test config and ``--device cpu`` the CPU
(the kernels' plain versions).  Weights are random, from ``--seed``.
"""

from __future__ import annotations

import argparse
import time
from typing import Sequence

import numpy as np
import torch

from ..configs import REGISTRY, get_config, reduced
from ..models import Model
from ..serving import ServeConfig, ServeEngine


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(REGISTRY), default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="the small family-preserving config of the CPU tests")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = Model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    print(f"[serve] {cfg.name}: {model.n_params() / 1e6:.1f}M params on {model.device}")

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab, size=(args.requests, args.prompt_len)).tolist()
    eng = ServeEngine(model, ServeConfig(max_batch=args.max_batch,
                                         temperature=args.temperature, seed=args.seed))
    t0 = time.perf_counter()
    outs = eng.generate(prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    gen_tokens = sum(len(o) - args.prompt_len for o in outs)
    print(f"[serve] {args.requests} requests, {gen_tokens} new tokens in {dt:.2f}s "
          f"({gen_tokens / dt:.1f} tok/s on {model.device}); stats={eng.stats}")
    print("[serve] sample:", outs[0][: args.prompt_len + 8])
    return {"outputs": outs, "stats": dict(eng.stats), "seconds": dt}


if __name__ == "__main__":
    main()
