#!/usr/bin/env python3
"""How far the sharded train step's gradient norms drift from the one-rank run's, by tensor.

Trains gemma3-1b at full width and depth with ``chip_smoke.py``'s train run
(B 4 x S 1024, lr 3e-3, warmup 5, the same seed and batches) for a few
steps: on one rank with 2 microbatches (the baseline) and with 4 (a control
that moves only the roundings), and on meshes of ranks that share the card
(a gloo group): by default (2, 2), (1, 2) tensor-parallel only, (2, 1)
data-parallel only.  Prints one JSON line a run: its losses, its gradient
norms, and for each step the relative difference of each tensor kind's
gradient norm (``embed``, ``attn.w_q``, ``mlp.w_down``, ... summed over the
layers) from the baseline's.  A difference alike across every kind is the
trajectory moving, not a tensor's fault.

``--float32`` runs every run with float32 parameters (TF32 off): where the
bf16 runs drift apart and the float32 ones do not, the drift is bf16
rounding grown by the trajectory, not a wrong sum.  Run from the repository
root on a machine with a CUDA device:
    python3 tools/sharded_divergence.py [--steps 4] [--float32] [--meshes 2x2,1x2,2x1]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402  (the train run's constants and recorder)

ARCH = cs.TRAIN_MAIN


def _train(microbatches: int, steps: int, float32: bool, mesh=None) -> dict:
    """Losses, gradient norms and each tensor kind's squared gradient norm
    (this rank's ZeRO pieces that count in the norm) at every step."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, Trainer

    batch, seq, _, total, lr, warmup = cs.TRAIN_RUNS[ARCH]
    cfg = get_config(ARCH)
    if float32:
        cfg = cfg.with_(param_dtype=torch.float32)
    dev = torch.device("cuda", 0)
    trainer = Trainer(Model(cfg, device=dev),
                      TrainConfig(microbatches=microbatches,
                                  optim=AdamWConfig(lr=lr, warmup_steps=warmup,
                                                    total_steps=total)), mesh=mesh)
    trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLMDataset(DataConfig(vocab=cs.TRAIN_DATA_VOCAB, seq_len=seq,
                                         global_batch=batch))
    with cs.recording_grad_squares(trainer) as squares:
        history = trainer.run(iter(data), steps, log_every=0)
    return {"losses": [h["loss"] for h in history],
            "grad_norms": [h["grad_norm"] for h in history], "squares": squares,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def _rank(rank: int, world: int, shape: dict, steps: int, float32: bool) -> dict:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.launch.mesh import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    return _train(2, steps, float32, Mesh(shape).bind())


def main() -> None:
    from repro_torch.distributed import run_world

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--meshes", default="2x2,1x2,2x1", help="data x model, comma-separated")
    args = ap.parse_args()
    meshes = [dict(zip(("data", "model"), map(int, m.split("x"))))
              for m in args.meshes.split(",")]
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    runs = {}
    for mb in (2, cs.SHARDED_CONTROL_MICROBATCHES):
        torch.cuda.reset_peak_memory_stats()
        runs[f"one rank, {mb} microbatches"] = _train(mb, args.steps, args.float32)
        torch.cuda.empty_cache()
    for shape in meshes:
        ranks = run_world(_rank, shape["data"] * shape["model"], shape, args.steps,
                          args.float32, timeout=1800)
        squares = [{} for _ in ranks[0]["squares"]]
        for r in ranks:
            for i, sq in enumerate(r["squares"]):
                for k, v in sq.items():
                    squares[i][k] = squares[i].get(k, 0.0) + v
        runs[f"mesh {shape['data']}x{shape['model']}"] = {
            **ranks[0], "squares": squares,
            "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks]}
    base = runs["one rank, 2 microbatches"]["squares"]
    dtype = "float32" if args.float32 else "bfloat16"
    for name, run in runs.items():
        drift = [{k: (v ** 0.5 - b[k] ** 0.5) / b[k] ** 0.5 for k, v in sq.items()}
                 for sq, b in zip(run["squares"], base)]
        print(json.dumps({"run": name, "dtype": dtype, "losses": run["losses"],
                          "grad_norms": run["grad_norms"],
                          "grad_norm_rel_diff_by_kind": drift,
                          "max_abs_rel_diff_by_step": [max(map(abs, d.values())) for d in drift],
                          "peak_mem_bytes": run["peak_mem_bytes"]}), flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
