#!/usr/bin/env python3
"""Is the expert-parallel step's gradient of olmoe's experts rounding, or a fault?

Runs ``tests/test_torch_sharded_train.py``'s float32 olmoe-1b-7b case on the
CPU: the reference's weights (its JAX subprocess), its two batches, its
train config.  The one-device step runs with the default thread count and
with one thread, the (1, 4) mesh (expert-parallel MoE, tensor-parallel
attention) in a gloo world of 4 ranks.  Each run's step gradients (the ones
AdamW takes) are recorded; at step 1 they are held against a float64 run of
the same one-device step (every float32 cast of the model made float64).

Prints one JSON line: at step 1 (every run at the same parameters) each
run's largest gradient error against float64, relative to the tensor's
largest gradient; at step 2 (each run at its own parameters, where float64
may route a token to other experts) each run's largest difference from the
one-device run; and for the watched entry (``--tensor``, ``--index``) each
run's gradient, float64's, the whole batch's without microbatches (not what
AdamW takes: it takes the microbatches' mean), and its parameter after each
step.  The expert-parallel gradient is a fault if its error stands far above
the one-device runs' (which differ from each other only by the BLAS's sum
order).  Run from the repository root (about two minutes):
    python3 tools/ep_gradient_rounding.py [--tensor blocks.0.moe.w_gate --index 0,58,10]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tests"), str(ROOT / "src")]

import test_torch_sharded_train as tst  # noqa: E402  (the test's case; imports no JAX)
from repro_torch.distributed import run_world  # noqa: E402
from repro_torch.distributed.sharding import gather_params, gather_tensor  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.training import build_train_step  # noqa: E402
from repro_torch.training import trainer as trainer_module  # noqa: E402

ARCH = "olmoe-1b-7b"


@contextlib.contextmanager
def _recording_step_grads(out: list):
    """Append each step's gradient pieces (what AdamW takes) to ``out``."""
    adamw_step = trainer_module.adamw_step

    def recording(params, grads, *args, **kwargs):
        out.append({k: g.detach().clone() for k, g in grads.items()})
        return adamw_step(params, grads, *args, **kwargs)

    trainer_module.adamw_step = recording
    try:
        yield
    finally:
        trainer_module.adamw_step = adamw_step


def _run(reference: dict, mesh=None) -> dict:
    """Step gradients (whole tensors) and parameters after each step."""
    cfg = tst._cfg(ARCH, "float32")
    model = Model(cfg, device="cpu")
    step = build_train_step(model, tst._tcfg(), mesh)
    model.load_state_dict(params_from_jax(reference[f"{ARCH}/float32"]["params"], cfg, mesh))
    state = step.init_state()
    grads, params = [], []
    for tokens, labels in reference["batches"]:
        recorded = []
        with _recording_step_grads(recorded):
            state, _ = step(state, torch.from_numpy(tokens), torch.from_numpy(labels))
        g = recorded[0]
        if mesh is not None:
            specs = step.shardings["state"]
            g = {k: gather_tensor(v, specs[k], mesh) for k, v in g.items()}
        grads.append({k: v.numpy() for k, v in g.items()})
        whole = gather_params(model) if mesh is not None else dict(model.named_parameters())
        params.append({k: v.detach().float().clone().numpy() for k, v in whole.items()})
    return {"grads": grads, "params": params}


def _rank_job(rank: int, world: int, reference: dict) -> dict:
    torch.set_num_threads(1)
    out = _run(reference, Mesh({"data": 1, "model": 4}).bind())
    return out if rank == 0 else {}


@contextlib.contextmanager
def _float64():
    """Every ``Tensor.float()`` of the model gives float64 instead."""
    cast = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = cast


def _grads(params: dict, batch, microbatches: int, float64: bool) -> dict:
    """The one-device gradients at ``params``: the mean of ``microbatches``
    slices' gradients (as ``build_train_step`` forms them), in float32 or in
    float64."""
    cfg = tst._cfg(ARCH, "float32")
    model = Model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    if float64:
        model.double()
    model.requires_grad_(True)
    tcfg = tst._tcfg()
    tokens, labels = (torch.from_numpy(t).reshape(microbatches, -1, t.shape[1]) for t in batch)
    sums = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    with _float64() if float64 else contextlib.nullcontext():
        for tk, lb in zip(tokens, labels):
            model.zero_grad(set_to_none=True)
            loss, _ = model.loss_fn(tk, lb, moe_loss_weight=tcfg.moe_loss_weight,
                                    z_loss_weight=tcfg.z_loss_weight)
            loss.backward()
            for k, p in model.named_parameters():
                if p.grad is not None:
                    sums[k] += p.grad
    return {k: (v / microbatches).numpy() for k, v in sums.items()}


def _of_largest(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tensor", default="blocks.0.moe.w_gate")
    ap.add_argument("--index", default="0,58,10")
    args = ap.parse_args()
    index = tuple(int(i) for i in args.index.split(","))

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "reference.pkl"
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
        subprocess.run([sys.executable, "-c", tst._REFERENCE, str(path)], env=env, check=True)
        with open(path, "rb") as f:
            reference = pickle.load(f)
    start = {k: np.asarray(v, np.float32)
             for k, v in params_from_jax(reference[f"{ARCH}/float32"]["params"],
                                         tst._cfg(ARCH, "float32")).items()}
    runs = {"one_device": _run(reference)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs["one_device_1_thread"] = _run(reference)
    torch.set_num_threads(threads)
    runs["ep_1x4"] = run_world(_rank_job, 4, reference, timeout=600)[0]

    t, mb = args.tensor, tst._tcfg().microbatches
    report = {"threads": threads, "tensor": t, "index": list(index)}
    # step 1, every run at the same parameters: each against float64
    batch = reference["batches"][0]
    g64 = _grads(start, batch, mb, float64=True)
    report["step1_error_of_largest_vs_float64"] = {
        name: {t: _of_largest(run["grads"][0][t], g64[t]),
               "worst_tensor": max((_of_largest(run["grads"][0][k], g64[k]), k) for k in g64)}
        for name, run in runs.items()}
    report["step1_entry"] = {
        "float64": float(g64[t][index]),
        # the whole batch's gradient, without microbatches (AdamW takes their mean)
        "one_device_whole_batch": float(_grads(start, batch, 1, float64=False)[t][index]),
        **{name: float(run["grads"][0][t][index]) for name, run in runs.items()}}
    # step 2, each run at its own parameters: the float32 runs against the one-device run
    base = runs["one_device"]["grads"][1]
    report["step2_difference_of_largest_vs_one_device"] = {
        name: {t: _of_largest(run["grads"][1][t], base[t]),
               "worst_tensor": max((_of_largest(run["grads"][1][k], base[k]), k) for k in base)}
        for name, run in runs.items() if name != "one_device"}
    report["step2_entry"] = {name: float(run["grads"][1][t][index]) for name, run in runs.items()}
    report["param_after_step"] = {name: [float(p[t][index]) for p in run["params"]]
                                  for name, run in runs.items()}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
