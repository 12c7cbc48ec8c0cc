"""Readings that a cell's limits are set from, on the card, at the cell's size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... --control 3

For every seed, in one process: the weights drawn from the seed, the cell's
first batch served at the cell's load through the same engine and probe as
a run, and every number ``oracle.readings`` reads against the float32
reference (the lower readings come from these).  For the first
``--control`` seeds, each of the cell's controls over the same sequences
too (``oracle.controls``: float8 products, and a bfloat16 state where the
configuration states a float32 one; their smallest readings are the upper
ones).  One JSON line a seed; the
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the controls")
    args = ap.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from portbench import cells, oracle, run, traffic, weights
    from repro_torch.models import Model
    from repro_torch.serving import ServeConfig, ServeEngine

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cells.load(ROOT, args.workload)
    m, mix = cell.model, cell.traffic
    model = Model(run.model_config(m), device=device)
    probe = run.Probe(model, device, cell.config.get("state_dtype", {}))
    for i, seed in enumerate(int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        s = run.norm_seed(seed)
        model.load_state_dict(weights.draw(cell.reference.params(m), s, device), strict=True)
        engine = ServeEngine(model, ServeConfig(max_batch=mix["batch"]))
        prompts = traffic.batch(mix, m["vocab"], s, 0)
        rows = oracle.sample_rows(prompts, s, 0, cell.limits["sample_requests"])
        outs, _, kept = probe.batch(engine, prompts, mix["new_tokens"], rows)
        batches = [{"prompts": prompts, "outs": outs, "rows": rows, "logits": kept,
                    "state_dtypes": probe.state_dtypes}]
        served_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        line = {"workload": cell.name, "seed": seed,
                **oracle.readings(cell, s, batches, device), "serve_s": served_s,
                "reference_s": time.perf_counter() - t0 - served_s}
        if i < args.control:
            line["control"] = oracle.control(cell, s, batches, device)
        print(json.dumps(line), flush=True)
        del engine, batches, kept
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
