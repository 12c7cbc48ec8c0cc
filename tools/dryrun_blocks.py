#!/usr/bin/env python3
"""Per-rank costs of the dry-run cells of the configs whose Mamba2, mLSTM or
MLA blocks compute their heads' share on a mesh, for one source tree.

For zamba2-2.7b, xlstm-125m, minicpm3-4b and kimi-k2-1t-mla, each cell of
train_4k, decode_32k and (where the config allows it) long_500k on the
meshes single (16 x 16) and 2x2, rank 0: ``launch/dryrun.py::trace_cell``
(``meta`` tensors, no world, no device memory) gives the rank's dot FLOPs,
aten bytes, peak live bytes, collective bytes and ops, and kernel calls;
each collective is priced on ``H100_SXM`` (``launch/roofline.py::topo_for``,
the reference's ring algebra): the bytes on its busiest link and its time,
summed over the step (an all-reduce moves twice a reduce-scatter's).
Each cell runs in a process of its own (``--jobs`` at once) that imports
the port from ``--src``, so the same command measures another tree (unpack
``git archive`` of it and pass its ``src``); ``--compare A B`` prints two
such runs' records side by side as a markdown table.

zamba2-2.7b's and xlstm-125m's train_4k cells are traced at S 64 in place
of 4096 (``TRAIN_SEQ_CUT``): their scans are Python loops over the tokens,
and on meta tensors a step of them takes about a second under the cost
counters, so the whole cell would take about an hour.  Every scan step is
the same computation, so the per-rank shares are those of the whole cell
but for zamba2's shared attention, whose products grow as S squared.

    python3 tools/dryrun_blocks.py [--src build/parent/src] --out OUT.json [--jobs 8]
    python3 tools/dryrun_blocks.py --compare BEFORE.json AFTER.json
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("zamba2-2.7b", "xlstm-125m", "minicpm3-4b", "kimi-k2-1t-mla")
SHAPES = ("train_4k", "decode_32k", "long_500k")
MESHES = ("single", "2x2")
TRAIN_SEQ_CUT = {"zamba2-2.7b": 64, "xlstm-125m": 64}


def _cell(job: tuple) -> dict:
    """One cell's record, traced in this (spawned) process from ``src``."""
    src, arch, shape_name, mesh_name = job
    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES as ALL, ShapeSpec
    from repro_torch.core.capture import collective_bytes
    from repro_torch.core.interconnect import H100_SXM
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import make_mesh_by_name
    from repro_torch.launch.roofline import topo_for

    shape = ALL[shape_name]
    if shape.mode == "train" and arch in TRAIN_SEQ_CUT:
        shape = ShapeSpec(shape.name, TRAIN_SEQ_CUT[arch], shape.global_batch, "train")
    t0 = time.perf_counter()
    trace = trace_cell(get_config(arch), shape, make_mesh_by_name(mesh_name))
    cost, topo = trace["cost"], topo_for(mesh_name, H100_SXM)
    priced = [topo.collective_on(o.kind, o.operand_bytes, o.axes) for o in trace["ops"]
              if o.group_size != 1]
    return {"arch": arch, "shape": shape_name, "seq": shape.seq_len, "mesh": mesh_name,
            "dot_flops": cost.dot_flops, "bytes": cost.bytes,
            "peak_bytes": cost.peak_live_bytes, "argument_bytes": cost.argument_bytes,
            "collective_bytes": collective_bytes(trace["ops"]), "collective_ops": len(trace["ops"]),
            "link_bytes": sum(c.link_bytes for c in priced),
            "collective_s": sum(c.time_s for c in priced),
            "kernel_calls": cost.kernel_calls, **trace["bytes"],
            "cache_deviations": sorted({f.split("[")[1].split("]")[0] for f in trace["fallbacks"]
                                        if f.startswith("cache ")}),
            "trace_s": time.perf_counter() - t0}


def _jobs(src: str) -> list:
    sys.path.insert(0, src)
    from repro_torch.configs import get_config

    return [(src, arch, shape, mesh) for arch in ARCHS for shape in SHAPES for mesh in MESHES
            if shape != "long_500k" or get_config(arch).supports_500k]


def _compare(before: str, after: str) -> None:
    def load(path):
        return {(r["arch"], r["shape"], r["mesh"]): r for r in json.load(open(path))}

    a, b = load(before), load(after)
    gb = 2 ** 30
    print("| arch | cell | mesh | dot TFLOP before / after (ratio) | GB moved before / after "
          "| peak GB before / after | collective GB before / after "
          "| link GB before / after |")
    print("|---|---|---|---|---|---|---|---|")
    order = {name: i for i, name in enumerate(ARCHS + SHAPES + MESHES)}
    for key in sorted(b, key=lambda k: [order[x] for x in k]):
        old, new = a[key], b[key]
        cell = key[1] if new["seq"] in (4096, 32768, 524288) else f"{key[1]} at S {new['seq']}"
        print(f"| {key[0]} | {cell} | {key[2]} | {old['dot_flops'] / 1e12:.4g} / "
              f"{new['dot_flops'] / 1e12:.4g} ({new['dot_flops'] / old['dot_flops']:.3f}) | "
              f"{old['bytes'] / gb:.4g} / {new['bytes'] / gb:.4g} | "
              f"{old['peak_bytes'] / gb:.4g} / {new['peak_bytes'] / gb:.4g} | "
              f"{old['collective_bytes'] / gb:.4g} / {new['collective_bytes'] / gb:.4g} | "
              f"{old['link_bytes'] / gb:.4g} / {new['link_bytes'] / gb:.4g} |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--compare", nargs=2, metavar=("BEFORE", "AFTER"))
    args = ap.parse_args(argv)
    if args.compare:
        _compare(*args.compare)
        return
    src = str(Path(args.src).resolve())
    with mp.get_context("spawn").Pool(args.jobs) as pool:
        records = []
        for rec in pool.imap_unordered(_cell, _jobs(src)):
            print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "dot_flops",
                                                  "trace_s")}), flush=True)
            records.append(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
