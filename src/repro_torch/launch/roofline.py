"""Roofline table of the dry-run records (port of ``repro/launch/roofline.py``).

Per (arch x shape x mesh) record of ``launch/dryrun.py``, on the hardware
``--hw`` names (``h100``, the default: ``H100_SXM``; ``v5e``: the
reference's ``V5E``, for comparison)::

  compute_s    = dot FLOPs a rank  / peak bf16 FLOP/s
  memory_s     = bytes a rank      / HBM bandwidth
  collective_s = collective bytes  / the last mesh axis's link bandwidth

with the dominant term, the useful-FLOPs ratio, the fit in HBM (peak live
bytes) and a one-line note on what would move the dominant term.

The topology (:func:`topo_for`): on ``v5e`` the reference's (every axis on
ICI, ``pod`` on DCI).  On ``h100`` the mesh's ranks fill 8-GPU NVLink nodes
in row-major order (the last axis fastest), and an axis rides NVLink only
where each of its groups lies inside one node (the whole mesh fits in a
node, or the axis's span, its size times the later axes', divides 8: on
2 x 3 both axes ride NVLink, on 2 x 6 neither); every other axis rides
InfiniBand (``dci_axes``), because a ring that crosses nodes is as slow as
its InfiniBand hops.  So on the 16 x 16 and 2 x 16 x 16 meshes ``model``
(16 GPUs, two nodes) is priced on InfiniBand like ``data`` and ``pod``; on a
2 x 4 mesh both axes ride NVLink.  ``Topology.describe`` marks the
InfiniBand axes "(IB)".

Usage::

  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir results/dryrun_torch]
      [--hw h100|v5e] [--json results/roofline_torch_h100.json] [--md ...]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Dict, List

from ..core.interconnect import HARDWARE, NVLINK_NODE_GPUS, V5E, HardwareSpec
from ..core.predictor import roofline
from ..core.topology import Topology

__all__ = ["build_table", "load_records", "render_markdown", "topo_for"]

DEFAULT_DIR = "results/dryrun_torch"

_ADVICE = {
    "compute": (
        "compute-bound: cut recompute (remat policy) or raise per-chip "
        "efficiency (larger matmul tiles / fused kernels)"
    ),
    "memory": (
        "HBM-bound: fuse elementwise chains, keep activations bf16, "
        "shrink optimizer-state traffic (ZeRO already on)"
    ),
    "collective": (
        "collective-bound: reduce-scatter instead of all-reduce for grads, "
        "bf16/int8 gradient compression, overlap collectives under compute"
    ),
}


def _mesh_axes(mesh_name: str):
    if mesh_name == "multi":
        return (2, 16, 16), ("pod", "data", "model")
    if mesh_name == "single":
        return (16, 16), ("data", "model")
    dims = tuple(int(x) for x in mesh_name.split("x"))
    names = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}[len(dims)]
    return dims, names


def _inside_nodes(span: int, n_ranks: int) -> bool:
    """Whether every group of an axis whose groups span ``span`` consecutive
    ranks (the product of its size and the later axes') lies inside one
    node: the whole mesh fits in one node, or the span divides the node."""
    return n_ranks <= NVLINK_NODE_GPUS or NVLINK_NODE_GPUS % span == 0


def topo_for(mesh_name: str, hw: HardwareSpec) -> Topology:
    """The topology of a named mesh on ``hw`` (the module's rule)."""
    dims, names = _mesh_axes(mesh_name)
    if hw == V5E:
        return Topology(dims, names, V5E)
    inter = tuple(n for i, n in enumerate(names)
                  if not _inside_nodes(math.prod(dims[i:]), math.prod(dims)))
    return Topology(dims, names, hw, dci_axes=inter)


def load_records(dir_: str, tag: str = "") -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        base = os.path.basename(path)[: -len(".json")]
        parts = base.split("__")
        rec_tag = parts[3] if len(parts) > 3 else ""
        if rec_tag != tag:
            continue
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def build_table(recs: List[Dict], hw: HardwareSpec = HARDWARE["h100"]) -> List[Dict]:
    rows = []
    for r in recs:
        if r.get("status") != "ok":
            rows.append({"arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
                         "status": r.get("status"),
                         "note": r.get("skip_reason", r.get("error", ""))})
            continue
        topo = topo_for(r["mesh"], hw)
        terms = roofline(
            arch=r["arch"],
            shape=r["shape"],
            mesh=r["mesh"],
            topo=topo,
            hlo_flops_per_device=r["flops_per_device"],
            hlo_bytes_per_device=r["bytes_per_device"],
            collective_bytes_per_device=int(r["collective_bytes_per_device"]),
            model_flops_total=r["model_flops"],
            bytes_per_device_hbm=int(r.get("hbm_bytes_per_device", 0)),
        )
        d = terms.as_dict()
        d["status"] = "ok"
        d["note"] = _ADVICE[terms.dominant]
        d["options"] = r.get("options", {})
        d["topology"] = topo.describe()
        rows.append(d)
    return rows


def render_markdown(rows: List[Dict]) -> str:
    hdr = (
        "| arch | shape | mesh | compute_s | memory_s | collective_s | "
        "dominant | useful | roofline_frac | HBM/dev | fits |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        if r.get("status") != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - | - | "
                f"{r.get('status')} | - | - | - | {r.get('note', '')[:60]} |"
            )
            continue
        lines.append(
            "| {arch} | {shape} | {mesh} | {c:.4f} | {m:.4f} | {k:.4f} | "
            "**{dom}** | {u:.2f} | {rf:.3f} | {gb:.1f} GiB | {fit} |".format(
                arch=r["arch"], shape=r["shape"], mesh=r["mesh"], c=r["compute_s"],
                m=r["memory_s"], k=r["collective_s"], dom=r["dominant"],
                u=r["useful_flops_ratio"], rf=r["roofline_fraction"],
                gb=r["bytes_per_device_hbm"] / 2**30, fit="yes" if r["fits_hbm"] else "NO",
            )
        )
    return hdr + "\n".join(lines) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--hw", choices=sorted(HARDWARE), default="h100")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="default: results/roofline_torch_<hw>.json")
    ap.add_argument("--md", dest="md_out", default=None,
                    help="default: results/roofline_torch_<hw>.md")
    args = ap.parse_args(argv)

    hw = HARDWARE[args.hw]
    rows = build_table(load_records(args.dir, args.tag), hw)
    json_out = args.json_out or f"results/roofline_torch_{args.hw}.json"
    md_out = args.md_out or f"results/roofline_torch_{args.hw}.md"
    for path in (json_out, md_out):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(json_out, "w") as f:
        json.dump(rows, f, indent=1)
    md = render_markdown(rows)
    with open(md_out, "w") as f:
        f.write(md)
    print(f"hardware: {hw.name}")
    for topo in sorted({r["topology"] for r in rows if "topology" in r}):
        print(f"topology: {topo}")
    print(md)
    ok = [r for r in rows if r.get("status") == "ok"]
    if ok:
        worst = min(ok, key=lambda r: r["roofline_fraction"])
        collb = max(ok, key=lambda r: r["collective_s"])
        print(f"worst roofline fraction: {worst['arch']} x {worst['shape']} "
              f"({worst['roofline_fraction']:.3f})")
        print(f"most collective-bound: {collb['arch']} x {collb['shape']} "
              f"({collb['collective_s']:.4f}s)")


if __name__ == "__main__":
    main()
