#!/usr/bin/env python3
"""The port's captured collective schedule beside XLA's for the same step.

Reduced gemma3-1b cut to 4 layers, B 8 x S 64, a 4 x 4 (data, model) mesh,
one train step (AdamW, one microbatch), as ``examples/traffic_study.py``
captures it:

- the reference: ``parse_collectives`` of the compiled sharded step's HLO,
  in a subprocess with 16 host devices (JAX on the CPU);
- the port: ``launch/dryrun.py::trace_cell`` of rank 0 (``meta`` tensors, no
  world): the exchanges that rank's step hands its buffers to.

It prints one table a side, by kind and by (kind, dtype, group size, and
the port's mesh axes): count and operand bytes a device.  The two programs choose their collectives
differently (XLA's SPMD partitioner picks reduce-scatters, permutes and
fused all-reduces; the port exchanges explicitly, one op a tensor), so the
tables are compared by what each op carries, not op for op.  Runs on the
CPU in about a minute:
    PYTHONPATH=src python tools/capture_vs_xla.py [--json OUT]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch.dryrun import trace_cell  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

LAYERS, BATCH, SEQ, MESH = 4, 8, 64, (4, 4)

_REFERENCE = f"""
import json, os
import jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.core.hlo_capture import parse_collectives
from repro.models import Model
from repro.optim import AdamWConfig, adamw_init
from repro.training import TrainConfig, build_train_step

cfg = reduced(get_config("gemma3-1b")).with_(n_layers={LAYERS})
mesh = jax.make_mesh({MESH}, ("data", "model"))
model = Model(cfg, mesh=mesh)
step_fn, _, _ = build_train_step(model, mesh, TrainConfig(optim=AdamWConfig()))
tok = jax.ShapeDtypeStruct(({BATCH}, {SEQ}), jnp.int32)
state = jax.eval_shape(lambda p: adamw_init(p, AdamWConfig()), model.abstract_params())
with mesh:
    compiled = step_fn.lower(model.abstract_params(), state, tok, tok).compile()
ops = parse_collectives(compiled.as_text())
print(json.dumps([dict(kind=o.kind, operand_bytes=o.operand_bytes, group_size=o.group_size,
                       dtype=o.dtype) for o in ops]))
"""


def _reference_ops() -> list:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=16"}
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=env, check=True,
                         capture_output=True, text=True, timeout=600).stdout
    return json.loads(out.strip().splitlines()[-1])


def _port_ops() -> list:
    cfg = reduced(get_config("gemma3-1b")).with_(n_layers=LAYERS)
    trace = trace_cell(cfg, ShapeSpec("capture_vs_xla", SEQ, BATCH, "train"),
                       Mesh({"data": MESH[0], "model": MESH[1]}), 0)
    return [dict(kind=o.kind, operand_bytes=o.operand_bytes, group_size=o.group_size,
                 dtype=o.dtype, axes=list(o.axes)) for o in trace["ops"]]


def table(ops: list) -> dict:
    by_kind, by_detail = defaultdict(lambda: [0, 0]), defaultdict(lambda: [0, 0])
    for o in ops:
        for row, key in ((by_kind, o["kind"]),
                         (by_detail, f"{o['kind']} {o['dtype']} g{o['group_size']}"
                                     + (f" {','.join(o['axes'])}" if o.get("axes") else ""))):
            row[key][0] += 1
            row[key][1] += o["operand_bytes"]
    return {"by_kind": {k: {"count": c, "bytes": b} for k, (c, b) in sorted(by_kind.items())},
            "by_kind_dtype_group": {k: {"count": c, "bytes": b}
                                    for k, (c, b) in sorted(by_detail.items())},
            "total_bytes": sum(o["operand_bytes"] for o in ops if o["group_size"] != 1)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", default=None, help="also write both tables here")
    args = ap.parse_args()
    out = {"config": {"arch": "gemma3-1b (reduced)", "layers": LAYERS, "batch": BATCH,
                      "seq": SEQ, "mesh": {"data": MESH[0], "model": MESH[1]}},
           "xla": table(_reference_ops()), "port": table(_port_ops())}
    for side in ("xla", "port"):
        print(f"== {side}: total operand bytes a device {out[side]['total_bytes']:,}")
        for key, row in out[side]["by_kind_dtype_group"].items():
            print(f"  {key:34s} n={row['count']:4d} bytes={row['bytes']:,}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
