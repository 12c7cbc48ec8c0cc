"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/`` and
``src/repro_torch``.  The system under test is
``repro_torch.serving.ServeEngine.generate`` on a ``repro_torch.models.Model``
in the configuration's dtype on ``cuda:0``, the way ``launch/serve.py``
drives it.

Set-up draws the weights from the seed on the card (``weights.py``), loads
them into the model, and warms the cell's shapes with one 2-step
``generate`` at the cell's batch; the port's CUDA kernels come from its
fixed build directory in the checkout (``build/kernels``), so only a
checkout's first run compiles them.  The window runs the mix's batches
back to back (``traffic.py``): the first always, a further one only where
it should end before ``--seconds`` have passed.  Then the program is freed
and the comparison (``oracle.py``) decides ``correct``.

``--trace 0`` prints the cell's end-to-end metrics:

``gen_tokens_per_s``  new tokens of the window's batches over the seconds
                      from the first batch's start to the last one's end
                      (host clock; prompt steps are in the time).
``itl_p95_ms``        the 95th percentile of the gaps between consecutive
                      new tokens of every request of the window: in a
                      static batch, the time of each decode step, taken by
                      CUDA events recorded on the stream as each decode
                      step is called (the engine has just read the last
                      token back), so the device's clock times each gap.
``setup_s``           from the start of this script to the window's start.

``--trace 1`` profiles one whole batch and prints the per-layer metrics,
each from its reader in ``metrics/``; a profile that lost kernel records is
made again on the next batch, up to three, while the run's time allows.

The last line of standard output is one JSON object; the numbers compared
are also the last lines of standard error.  Without a card, or with fewer
cards than the cell asks for, it prints no result and exits 2; where
``jax``, ``jaxlib``, ``flax`` or ``repro`` was imported, it exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

import torch  # noqa: E402

T_TORCH = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
MAX_TRACE_ATTEMPTS = 3
TRACE_BUDGET_S = 240  # no further profile where it would end past this (the run has 360)


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules, compared whole
    (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def norm_seed(seed: int) -> int:
    """Any whole number as a seed for numpy and torch (both take 0..2^63)."""
    return seed % (1 << 63)


class Probe:
    """Wraps ``model.decode_step`` from outside the program.  As each decode
    step of a batch is called it marks the time (a CUDA event on the card,
    the host clock elsewhere); for the batch's sampled rows it keeps the
    logits that the step returns at the positions that choose their new
    tokens, for the comparison after the window (``oracle.py``), and at the
    first of them the dtypes of the cache tensors named in ``watch``
    (``state_dtypes``: {"name:dtype": tensors})."""

    def __init__(self, model, device, watch=()):
        self.inner, self.device, self.watch = model.decode_step, device, set(watch)
        self.first_decode, self.rows, self.new, self.kept = 1 << 62, None, 0, None
        self.marks: list = []
        self.state_dtypes: dict = {}
        model.decode_step = self.step

    def step(self, caches, tokens, pos, **kw):
        if pos >= self.first_decode:
            if self.device.type == "cuda":
                evt = torch.cuda.Event(enable_timing=True)
                evt.record()
                self.marks.append(evt)
            else:
                self.marks.append(time.perf_counter())
        logits, caches = self.inner(caches, tokens, pos, **kw)
        k = pos - (self.first_decode - 1)
        if k == 0 and self.watch:
            seen: dict = {}
            for cache in caches:
                for name, t in cache.items():
                    if name in self.watch:
                        key = f"{name}:{str(t.dtype).removeprefix('torch.')}"
                        seen[key] = seen.get(key, 0) + 1
            self.state_dtypes = seen
        if self.rows is not None and 0 <= k < self.new:
            if self.kept is None:  # one buffer a batch, [new tokens, rows, vocab]
                self.kept = logits.new_empty((self.new, len(self.rows), logits.shape[-1]))
            torch.index_select(logits, 0, self.rows, out=self.kept[k])
        return logits, caches

    def batch(self, engine, prompts, new_tokens, rows):
        """``(outputs, gaps in seconds between consecutive new tokens, the
        sampled rows' logits [rows, new_tokens, vocab])`` of one ``generate``
        call of a whole batch."""
        self.first_decode, self.new, self.marks, self.kept, self.state_dtypes = (
            max(len(p) for p in prompts), new_tokens, [], None, {})
        self.rows = torch.tensor(rows, device=self.device)
        outs = engine.generate(prompts, new_tokens)
        marks, kept = self.marks, self.kept
        self.first_decode, self.rows, self.marks, self.kept = 1 << 62, None, [], None
        if self.device.type == "cuda":
            marks[-1].synchronize()
            gaps = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        else:
            gaps = [b - a for a, b in zip(marks, marks[1:])]
        return outs, gaps, kept.transpose(0, 1)


def model_config(m: dict):
    """The program's ``ModelConfig`` from the configuration file's sizes."""
    from repro_torch.models.common import ModelConfig

    fields = dict(m)
    fields["param_dtype"] = getattr(torch, fields.get("param_dtype", "bfloat16"))
    return ModelConfig(**fields)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float,
             marks: Optional[list] = None) -> dict:
    """One run of ``cell`` on ``device``: the result's object.  ``marks``:
    the set-up's steps so far, ``(name, host clock at its end)`` from
    ``("start", t0)``; the set-up's time by step goes to standard error."""
    import numpy as np

    from portbench import oracle, traffic, weights
    from portbench import trace as trace_mod
    from portbench.cells import Observed
    from repro_torch.models import Model
    from repro_torch.serving import ServeConfig, ServeEngine

    s = norm_seed(seed)
    mix, m = cell.traffic, cell.model
    B, new, hi = mix["batch"], mix["new_tokens"], mix["prompt_len"][1]
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    marks = list(marks or [("start", t0)]) + [("imports", time.perf_counter())]
    model = Model(model_config(m), device=device)
    sync()
    marks.append(("model", time.perf_counter()))
    drawn = weights.draw(cell.reference.params(m), s, device)
    model.load_state_dict(drawn, strict=True)
    del drawn
    sync()
    marks.append(("weights", time.perf_counter()))
    engine = ServeEngine(model, ServeConfig(max_batch=B, temperature=0.0, seed=s))
    probe = Probe(model, device, cell.config.get("state_dtype", {}))
    n_rows = cell.limits["sample_requests"]
    # warm every shape of the cell: a 2-step batch at the cell's batch, then
    # a step at the last position on the caches of a whole batch and the
    # probe's buffer for a whole batch, so that the allocator holds what the
    # window asks for
    probe.batch(engine, [[1, 1]] * B, 2, list(range(min(n_rows, B))))
    caches = model.init_caches(B, hi + new)
    logits = model.decode_step(caches, torch.ones(B, dtype=torch.long, device=device),
                               hi + new - 1)[0]
    kept = logits.new_empty((new, min(n_rows, B), logits.shape[-1]))  # the probe's buffer
    del caches, logits, kept
    gc.collect()
    sync()
    marks.append(("warm-up", time.perf_counter()))
    allocs = _device_allocs(device)
    setup_s = time.perf_counter() - t0
    print("[portbench] set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])), file=sys.stderr)

    def serve(index):
        prompts = traffic.batch(mix, m["vocab"], s, index)
        rows = oracle.sample_rows(prompts, s, index, n_rows)
        outs, gaps, kept = probe.batch(engine, prompts, new, rows)
        return {"prompts": prompts, "outs": outs, "rows": rows, "logits": kept,
                "state_dtypes": probe.state_dtypes}, gaps

    batches: list = []
    result: dict = {"metrics": {}, "device": {}}
    if not trace:
        gaps: List[float] = []
        t_open = time.perf_counter()
        last = 0.0
        while not batches or time.perf_counter() - t_open + last <= seconds:
            t_b = time.perf_counter()
            done, g = serve(len(batches))
            last = time.perf_counter() - t_b
            batches.append(done)
            gaps += g
        window = time.perf_counter() - t_open
        tokens = sum(len(o) - len(p) for b in batches for p, o in zip(b["prompts"], b["outs"]))
        metrics = {"gen_tokens_per_s": (tokens / window, "tokens/s"),
                   "itl_p95_ms": (1e3 * float(np.percentile(gaps, 95)), "ms"),
                   "setup_s": (setup_s, "s")}
        result["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()
                             if k in cell.end_to_end}
        print(f"[portbench] {cell.name}: {len(batches)} batches, {tokens} new tokens in "
              f"{window:.3f} s, {len(gaps)} gaps a request", file=sys.stderr)
    else:
        for index in range(MAX_TRACE_ATTEMPTS):
            before = dict(engine.stats)
            t_p = time.perf_counter()
            tr, (done, _) = trace_mod.profile(lambda: serve(index), device)
            took = time.perf_counter() - t_p
            batches = [done]
            if tr is None:
                break
            print(f"[portbench] profile {index}: {took:.1f} s, window {tr.window_s:.3f} s, "
                  f"{len(tr.kernels)} kernels, {tr.launches} launch calls", file=sys.stderr)
            if tr.complete or time.perf_counter() - t0 + took > TRACE_BUDGET_S:
                break
        stats = {k: engine.stats[k] - before[k] for k in engine.stats}
        obs = Observed(model=m, traffic=mix, kind=_kind(device),
                       prompt_lens=[len(p) for p in done["prompts"]],
                       steps=stats["prefill_tokens"] // B + stats["decode_steps"],
                       stats=stats, trace=tr)
        for entry in cell.per_layer:
            value = cell.reader(entry["name"]).read(obs)
            if value is not None:
                result["metrics"][entry["name"]] = {"value": float(value), "unit": entry["unit"]}
        if obs.device_trace is not None:
            result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = {"device_ops": tr.top_kernels(), "idle_gaps": tr.idle_gaps()}

    print(f"[portbench] device allocations in the window: {_device_allocs(device) - allocs}",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del engine, probe, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    read = oracle.readings(cell, s, batches, device)
    compared = oracle.checks(cell, read)
    print(f"[portbench] readings: {json.dumps(read)}", file=sys.stderr)
    result["device"] = {"platform": "gpu" if cuda else device.type, "kind": _kind(device),
                        "count": 1, "memory_peak_bytes": int(peak), **result["device"]}
    return {"correct": oracle.is_correct(compared),
            "attempted": sum(len(b["prompts"]) for b in batches),
            "failed": read["malformed_outputs"], **result, "checks": compared}


def _device_allocs(device) -> int:
    """The caching allocator's calls to ``cudaMalloc`` so far (0 off the card)."""
    if device.type != "cuda":
        return 0
    return torch.cuda.memory_stats(device).get("segment.all.allocated", 0)


def _kind(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    # the port builds its kernels into <checkout>/build/kernels itself; any
    # other compile cache a library keeps goes beside it, at fixed paths
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    from portbench import cells

    cell = cells.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[portbench] {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)  # the device's context
    torch.cuda.synchronize(device)
    marks = [("start", T0), ("torch", T_TORCH), ("cuda", time.perf_counter())]
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T0, marks)
    found = forbidden_modules()
    if found:
        print(f"[portbench] the run imported {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    print(f"[portbench] card: {_power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[portbench] check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
