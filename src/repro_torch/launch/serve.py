"""Batched-serving command line of the port: token-by-token prefill + decode.

Runs any architecture of the registry (``--arch``) at full width on the
CUDA device by default:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --requests 4 --prompt-len 480 --new-tokens 64
``--reduced`` takes the small CPU-test config and ``--device cpu`` the CPU
(the kernels' plain versions).  Weights are random, from ``--seed``.

``--mesh AxB`` serves the model bound to a (data A, model B) mesh: A·B ranks,
one spawned process each, in a gloo group (``distributed.run_world``); on
the card every rank shares ``cuda:0``.  Each rank draws the whole weights
from the seed and keeps its shards, decodes its rows of each batch, and
returns every request's tokens; rank 0 prints:
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu --mesh 2x2
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


def _serve(rank: int, world: int, args, mesh_shape=None) -> dict:
    """Build the model (bound to ``mesh_shape`` where given), serve the
    prompts and return the outputs; rank 0 prints."""
    from .mesh import Mesh

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if mesh_shape is not None and args.device == "cuda":
        torch.cuda.set_device(0)
    model = Model(cfg, device=args.device,
                  mesh=None if mesh_shape is None else Mesh(mesh_shape).bind())
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    where = f"{model.device}" + ("" if mesh_shape is None else f", mesh {mesh_shape}")
    if rank == 0:
        print(f"[serve] {cfg.name}: {model.n_params() / 1e6:.1f}M params on {where}")

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab, size=(args.requests, args.prompt_len)).tolist()
    eng = ServeEngine(model, ServeConfig(max_batch=args.max_batch,
                                         temperature=args.temperature, seed=args.seed))
    t0 = time.perf_counter()
    outs = eng.generate(prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    if rank == 0:
        gen_tokens = sum(len(o) - args.prompt_len for o in outs)
        print(f"[serve] {args.requests} requests, {gen_tokens} new tokens in {dt:.2f}s "
              f"({gen_tokens / dt:.1f} tok/s on {where}); stats={eng.stats}")
        print("[serve] sample:", outs[0][: args.prompt_len + 8])
    return {"outputs": outs, "stats": dict(eng.stats), "seconds": dt}


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(REGISTRY), default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="the small family-preserving config of the CPU tests")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="AxB: serve on a (data A, model B) mesh of A*B gloo ranks")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mesh is None:
        return _serve(0, 1, args)
    from ..distributed import run_world

    dims = [int(n) for n in args.mesh.split("x")]
    if len(dims) != 2 or min(dims) < 1:
        ap.error(f"--mesh takes AxB, got {args.mesh!r}")
    shape = {"data": dims[0], "model": dims[1]}
    return run_world(_serve, dims[0] * dims[1], args, shape, timeout=3600)[0]


if __name__ == "__main__":
    main()
