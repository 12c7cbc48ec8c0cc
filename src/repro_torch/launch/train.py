"""Training command line of the port (``repro.launch.train``).

Trains any architecture of the registry (``--arch``) at full width on the
CUDA device by default, on the synthetic Markov-chain data:
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --steps 200 \\
      --batch 8 --seq 128 --data-vocab 4096 --ckpt-dir /tmp/ckpt
``--reduced`` takes the small CPU-test config and ``--device cpu`` the CPU
(the kernels' plain versions).  Weights are random, from seed 0.  The data's
vocabulary is the model's, as in the reference, unless ``--data-vocab`` gives
a smaller one (token ids 0 .. data_vocab - 1): the data's transition table is
``vocab x vocab`` float64, 20 GB an array at xlstm-125m's 50,304.

``--mesh AxB`` (data x model; ``AxBxC`` adds pods) runs the sharded step on
A * B ranks spawned on this host in a gloo group; the ranks share the card
when there is one.  Without it the step runs on one device.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Sequence

import torch

from ..configs import REGISTRY, get_config, reduced
from ..data import DataConfig, SyntheticLMDataset, prefetch
from ..distributed.world import run_world
from ..models import Model
from ..optim import AdamWConfig
from ..training import TrainConfig, Trainer
from .mesh import make_mesh_by_name

WORLD_TIMEOUT_S = 7 * 24 * 3600.0


def main(argv: Sequence[str] | None = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(REGISTRY), default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving reduced config (CPU-friendly)")
    ap.add_argument("--layers", type=int, default=0, help="override n_layers")
    ap.add_argument("--d-model", type=int, default=0, help="override d_model")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--data-vocab", type=int, default=0,
                    help="vocabulary of the synthetic data (default: the model's)")
    ap.add_argument("--mesh", default=None,
                    help="AxB data x model (AxBxC: pod x data x model): that many ranks")
    args = ap.parse_args(argv)
    cfg = _config(args)
    if args.data_vocab > cfg.vocab:
        ap.error(f"--data-vocab {args.data_vocab} exceeds the model's vocabulary {cfg.vocab}")
    if args.mesh:
        mesh = make_mesh_by_name(args.mesh)
        return run_world(_rank, mesh.size, vars(args), timeout=WORLD_TIMEOUT_S)[0]
    return _train(args, cfg)


def _config(args: argparse.Namespace):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    overrides = {}
    if args.layers:
        overrides["n_layers"] = args.layers
    if args.d_model:
        overrides["d_model"] = args.d_model
    return cfg.with_(**overrides) if overrides else cfg


def _rank(rank: int, world: int, args: dict) -> list:
    """One rank of ``--mesh``: the card shared (or the rank's own), the mesh bound."""
    args = argparse.Namespace(**args)
    mesh = make_mesh_by_name(args.mesh).bind()
    if args.device == "cuda" and torch.cuda.is_available():
        args.device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(args.device)
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    return _train(args, _config(args), mesh)


def _train(args: argparse.Namespace, cfg, mesh=None) -> list:
    model = Model(cfg, device=args.device)
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        remat_policy=args.remat,
        optim=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps),
    )
    trainer = Trainer(model, tcfg, mesh=mesh, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every)
    main_rank = trainer.is_main
    if main_rank:
        print(f"[train] {cfg.name}: {model.n_params() / 1e6:.1f}M params "
              f"({model.n_active_params() / 1e6:.1f}M active) on {model.device}"
              + (f", mesh {mesh.shape}" if mesh is not None else ""))
    if not trainer.maybe_restore():
        trainer.init_state(torch.Generator(device=model.device).manual_seed(0))
        if main_rank:
            print("[train] fresh init")
    elif main_rank:
        print(f"[train] restored from step {trainer.step}")

    data = SyntheticLMDataset(DataConfig(vocab=args.data_vocab or cfg.vocab,
                                         seq_len=args.seq, global_batch=args.batch))
    t0 = time.perf_counter()
    history = trainer.run(prefetch(iter(data)), args.steps, log_every=args.log_every)
    dt = time.perf_counter() - t0
    if history and main_rank:
        tokens = args.steps * args.batch * args.seq
        print(f"[train] {len(history)} steps in {dt:.1f}s ({tokens / dt:,.0f} tok/s); "
              f"loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
    if args.metrics_out and main_rank:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return history


if __name__ == "__main__":
    main()
