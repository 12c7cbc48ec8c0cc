"""Dry run: one rank's step of every (arch x shape x mesh) cell, traced with
no world and no device memory (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell with XLA on 512 host devices and
reads memory, cost and collectives off the compiled module.  The port runs
the step itself, for one rank (``--rank``, default 0) of the cell's mesh:
the model is :meth:`Model.abstract` (``meta`` tensors: shapes, no data), the
mesh is bound with no world (``Mesh.bind_abstract``: its exchanges record
what they are handed and exchange nothing), and the inputs are
``launch/specs.py``'s stand-ins.  The same Python code runs the sharded step
on the card, so what is recorded is what that rank exchanges there:

- the rank's collective schedule (``core/capture.py``: kind, dtype, bytes,
  group size and mesh axes of each op, in order);
- its costs (``core/cost.py``): dot FLOPs, bytes of the aten ops, argument,
  peak live and output bytes, and the calls to each kernel.

Each cell writes one JSON record in the reference's schema: the port's
FLOPs are dot FLOPs (``flops_per_device`` = ``dot_flops_per_device``),
``lower_s`` is the trace's host seconds (there is no compile:
``compile_s``, ``xla_*`` and ``max_scan_trip`` are null) and ``memory`` holds
the bytes the port can give: ``argument_bytes``, ``param_bytes``,
``state_bytes`` (the moments and the float32 master), ``grad_buffer_bytes``
(from shapes: each ``.grad`` and, with microbatches, the float32
accumulators), ``cache_bytes`` (a decode cell's caches: the rank's shards),
``peak_bytes`` and ``output_bytes``.  It adds ``collective_schedule``,
``axes``, ``rank``, ``coord``, ``kernel_calls`` and ``aten_ops``.
``model_flops`` is 6 · N_active · tokens for train, 2 · N_active · tokens
for prefill and 2 · N_active · B for decode (one token a row).

Train cells run ``build_train_step`` (ZeRO-1, AdamW with a float32 master,
none with ``--no-master``; ``--remat``, ``--microbatches``); the port's
train step takes tokens, so a config with a stub frontend trains on its
token embedding.  Prefill cells run ``Model.prefill`` on the rank's rows.
Decode cells (``decode_32k``, ``long_500k``) run ``Model.decode_step`` on
the rank's rows (all of them where the batch axes do not divide the batch:
``long_500k``'s one row, sequence-parallel over ``data``) against the
rank's shards of a cache of the cell's S slots, placed as
``Model.cache_specs`` says, at the last slot (``pos`` = S - 1: the valid
prefix is the whole cache); the placement's deviations from the
reference's go into ``fallbacks``.  ``--mla-absorbed`` decodes MLA in
latent space.  ``--trace`` also writes each cell's ``TraceBundle`` (``schedule_to_trace``
on the cell's topology on ``H100_SXM``) under ``<out>/traces/``: steps 1-2 of
``examples/traffic_study.py``; the replay is the reference simulator's.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k \\
      --mesh single [--trace]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from ..configs import META, REGISTRY, get_config
from ..configs.shapes import SHAPES, ShapeSpec, cells_for
from ..core.capture import (CollectiveOp, by_kind, capture_collectives, collective_bytes,
                            schedule_to_trace)
from ..core.cost import count_cost, output_bytes, tensor_bytes
from ..core.interconnect import H100_SXM
from ..distributed.sharding import shard_params
from ..models import Model
from ..models.common import ModelConfig, count_params
from ..models.model import cache_specs, param_specs
from ..optim import AdamWConfig
from ..training import TrainConfig, build_train_step
from .mesh import Mesh, make_mesh_by_name
from .roofline import topo_for
from .specs import input_specs, rank_rows

__all__ = ["run_cell", "trace_cell", "cell_path", "trace_path", "schedule_of", "main", "REFUSED"]

DEFAULT_OUT = "results/dryrun_torch"
REFUSED = {  # the reference's options the port has no counterpart for
    "attn_constraints": "--attn-constraints: the port holds its shards explicitly; "
                        "there are no sharding constraints to add",
}


def _state_tensors(state) -> List[torch.Tensor]:
    out = []
    for v in state.values():
        out.extend(v.values() if isinstance(v, dict) else [v])
    return out


def _trace_train(model: Model, mesh, shape: ShapeSpec, opts) -> Dict[str, Any]:
    mb = opts.get("microbatches", 1)
    tcfg = TrainConfig(microbatches=mb, remat_policy=opts.get("remat", "none"),
                       optim=AdamWConfig(master_fp32=not opts.get("no_master", False)))
    step = build_train_step(model, tcfg, mesh)
    state = step.init_state()
    ins = input_specs(model, shape)
    params = list(model.parameters())
    args = params + _state_tensors(state) + [ins["tokens"], ins["labels"]]
    with capture_collectives() as ops, count_cost(args) as cost:
        out = step(state, ins["tokens"], ins["labels"])
    cost.output_bytes = output_bytes(out, args)
    pbytes = tensor_bytes(params)
    n_local = sum(p.numel() for p in params)
    per_param = [t for key in ("mu", "nu", "master") for t in state.get(key, {}).values()]
    return {"ops": ops, "cost": cost, "fallbacks": step.fallbacks,
            "bytes": {"param_bytes": pbytes, "state_bytes": tensor_bytes(per_param),
                      "grad_buffer_bytes": pbytes + (4 * n_local if mb > 1 else 0)}}


def _trace_prefill(model: Model, mesh, shape: ShapeSpec, opts) -> Dict[str, Any]:
    fallbacks = [] if mesh is None else shard_params(model, mesh)
    ins = input_specs(model, shape)
    if mesh is not None:
        ins = {k: rank_rows(v, mesh) for k, v in ins.items()}
    params = list(model.parameters())
    args = params + list(ins.values())
    with capture_collectives() as ops, count_cost(args) as cost:
        if "embeds" in ins:
            out = model.prefill(None, embeds=ins["embeds"])
        else:
            out = model.prefill(ins["tokens"])
    cost.output_bytes = output_bytes(out, args)
    return {"ops": ops, "cost": cost, "fallbacks": fallbacks,
            "bytes": {"param_bytes": tensor_bytes(params), "state_bytes": 0,
                      "grad_buffer_bytes": 0}}


def _trace_decode(model: Model, mesh, shape: ShapeSpec, opts) -> Dict[str, Any]:
    fallbacks = [] if mesh is None else shard_params(model, mesh)
    ins = input_specs(model, shape)
    B, S = shape.global_batch, shape.seq_len
    if mesh is not None:
        fallbacks += cache_specs(model.cfg, mesh, B, S, model.shardings)[1]
        ins.update({k: rank_rows(ins[k], mesh) for k in ("tokens", "embeds") if k in ins})
    caches = ins["caches"]
    params = list(model.parameters())
    cache_tensors = [t for entry in caches for t in entry.values()]
    kv_tensors = [t for cols in caches.kv or () if cols for t in cols.values()]
    args = params + cache_tensors + kv_tensors + [ins["tokens"]] + ([ins["embeds"]] if "embeds" in ins else [])
    with capture_collectives() as ops, count_cost(args) as cost:
        if "embeds" in ins:
            out = model.decode_step(caches, None, ins["pos"], embeds=ins["embeds"])
        else:
            out = model.decode_step(caches, ins["tokens"], ins["pos"])
    cost.output_bytes = output_bytes(out, args)
    return {"ops": ops, "cost": cost, "fallbacks": fallbacks,
            "bytes": {"param_bytes": tensor_bytes(params), "state_bytes": 0,
                      "grad_buffer_bytes": 0, "cache_bytes": tensor_bytes(cache_tensors)}}


_TRACES = {"train": _trace_train, "prefill": _trace_prefill, "decode": _trace_decode}
# the record of a MoE cell traced in another dtype than bf16 (moe.grouped_ffn)
MOE_STANDIN_BYTES = ("grouped_ffn: the expert products of a {dtype} trace are taken on bf16 "
                     "stand-ins (the meta function of _grouped_mm takes bf16 only), so the "
                     "bytes count two casts the card does not make and the expert weights "
                     "and activations at half their width: bytes_per_device is approximate")


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: Optional[Mesh], rank: int = 0,
               opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Trace global ``rank``'s train, prefill or decode step of ``cfg`` at
    ``shape`` on ``mesh`` (None: the one-device step, no mesh) with no world:
    ``{"ops", "cost", "fallbacks", "bytes", "coord", "trace_s"}`` (the
    schedule, the :class:`~..core.cost.StepCost`, the rules' fallback log
    with a decode cell's cache deviations, and the parameter, state,
    gradient-buffer and, for decode, cache bytes; a MoE config in another
    dtype than bf16 gets :data:`MOE_STANDIN_BYTES` in its fallbacks).
    ``opts``: ``remat``, ``microbatches``, ``no_master``, ``mla_absorbed``."""
    opts = opts or {}
    if opts.get("mla_absorbed"):
        cfg = cfg.with_(mla_absorbed_decode=True)
    bound = None if mesh is None else mesh.bind_abstract(rank)
    model = Model.abstract(cfg)
    t0 = time.perf_counter()
    out = _TRACES[shape.mode](model, bound, shape, opts)
    if cfg.n_experts and cfg.param_dtype != torch.bfloat16:
        dtype = str(cfg.param_dtype).removeprefix("torch.")
        out["fallbacks"] = [*out["fallbacks"], MOE_STANDIN_BYTES.format(dtype=dtype)]
    return {**out, "coord": {} if bound is None else bound.coord,
            "trace_s": time.perf_counter() - t0}


def run_cell(arch: str, shape_name: str, mesh_name: str,
             opts: Optional[Dict[str, Any]] = None, *, rank: int = 0,
             cfg: Optional[ModelConfig] = None, verbose: bool = True) -> Dict[str, Any]:
    """The record of one cell, traced for global ``rank`` of its mesh;
    ``cfg`` in place of the registry's config of ``arch`` (a reduced one)."""
    opts = opts or {}
    refused = [REFUSED[k] for k in opts if k in REFUSED and opts[k]]
    if refused:
        raise ValueError("; ".join(refused))
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "mode": shape.mode,
        "options": opts,
        "meta": META.get(arch, {}),
        "status": "ok",
    }
    if shape_name == "long_500k" and not cfg.supports_500k:
        rec["status"] = "skipped"
        rec["skip_reason"] = "pure full-attention arch; long_500k skipped per assignment"
        return rec
    mesh = make_mesh_by_name(mesh_name)
    n_active = Model.abstract(cfg).n_active_params()
    rec.update(n_params=count_params(param_specs(cfg)), n_active_params=n_active,
               axes=dict(mesh.shape), rank=rank)
    factor = 6.0 if shape.mode == "train" else 2.0
    tokens = shape.global_batch if shape.mode == "decode" else shape.tokens
    rec["model_flops"] = factor * n_active * tokens
    try:
        trace = trace_cell(cfg, shape, mesh, rank, opts)
        ops, cost, trace_s = trace["ops"], trace["cost"], trace["trace_s"]
        rec.update({
            "coord": trace["coord"],
            "lower_s": round(trace_s, 2),
            "compile_s": None,
            "fallbacks": trace["fallbacks"],
            "flops_per_device": float(cost.dot_flops),
            "dot_flops_per_device": float(cost.dot_flops),
            "bytes_per_device": float(cost.bytes),
            "xla_flops_raw": None,
            "xla_bytes_raw": None,
            "max_scan_trip": None,
            "memory": {"argument_bytes": cost.argument_bytes, **trace["bytes"],
                       "peak_bytes": cost.peak_live_bytes, "output_bytes": cost.output_bytes},
            "collectives": {k: {"count": c, "bytes": b} for k, (c, b) in by_kind(ops).items()},
            "collective_bytes_per_device": float(collective_bytes(ops)),
            "n_collective_ops": len(ops),
            "hbm_bytes_per_device": cost.peak_live_bytes,
            "kernel_calls": cost.kernel_calls,
            "aten_ops": cost.ops,
            "collective_schedule": [dataclasses.asdict(o) for o in ops],
        })
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name} (rank {rank}): "
                  f"trace={trace_s:.1f}s dot_flops/dev={cost.dot_flops:.3e} "
                  f"coll_bytes/dev={collective_bytes(ops):,} "
                  f"peak/dev={cost.peak_live_bytes / 2**30:.2f} GiB")
    except Exception as e:  # noqa: BLE001 - recorded; the CLI exits non-zero
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: ERROR {e}")
    return rec


def schedule_of(rec: Dict[str, Any]) -> List[CollectiveOp]:
    """The record's collective schedule as :class:`CollectiveOp`s."""
    return [CollectiveOp(**{**d, "axes": tuple(d["axes"])}) for d in rec["collective_schedule"]]


def cell_path(out_dir: str, arch: str, shape: str, mesh: str, tag: str = "") -> str:
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}{suffix}.json")


def trace_path(out_dir: str, arch: str, shape: str, mesh: str, tag: str = "") -> str:
    """Where ``--trace`` writes a cell's bundle (a subdirectory, so the
    roofline's record glob does not meet it)."""
    return cell_path(os.path.join(out_dir, "traces"), arch, shape, mesh, tag)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(REGISTRY), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", default="both", help="single|multi|both|AxB[xC]")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="", help="variant tag for perf iterations")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--trace", action="store_true",
                    help="also write each cell's TraceBundle under <out>/traces/")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-master", action="store_true",
                    help="train cells: AdamW without the float32 master")
    ap.add_argument("--mla-absorbed", action="store_true",
                    help="decode cells: MLA attends in latent space")
    for flag in REFUSED:
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help="refused: " + REFUSED[flag])
    args = ap.parse_args(argv)
    refused = [msg for flag, msg in REFUSED.items() if getattr(args, flag)]
    if refused:
        print("error: " + "; ".join(refused), file=sys.stderr)
        raise SystemExit(2)

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    opts = {"remat": args.remat, "microbatches": args.microbatches,
            "no_master": args.no_master, "mla_absorbed": args.mla_absorbed}
    opts = {k: v for k, v in opts.items()
            if not (v == "none" or v is False or (k == "microbatches" and v == 1))}

    if args.all:
        cells = [(arch, shape_name) for arch in REGISTRY
                 if META.get(arch, {}).get("tier") != "variant"
                 for shape_name, _ in cells_for(get_config(arch))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, are required")
        cells = [(args.arch, args.shape)]

    n = {"ok": 0, "skipped": 0, "error": 0}
    for mesh_name in meshes:
        for arch, shape_name in cells:
            path = cell_path(args.out, arch, shape_name, mesh_name, args.tag)
            if args.skip_existing and os.path.exists(path):
                continue
            rec = run_cell(arch, shape_name, mesh_name, opts)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            n[rec["status"]] += 1
            if args.trace and rec["status"] == "ok":
                topo = topo_for(mesh_name, H100_SXM)
                bundle = schedule_to_trace(schedule_of(rec), topo)
                tpath = trace_path(args.out, arch, shape_name, mesh_name, args.tag)
                os.makedirs(os.path.dirname(tpath), exist_ok=True)
                bundle.save(tpath)
                print(f"[dryrun] trace: {len(bundle)} writes over {bundle.span_ns():.0f} ns "
                      f"on {topo.describe()} -> {tpath}")
    print("[dryrun] done: " + " ".join(f"{k}={v}" for k, v in n.items()))
    if n["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
