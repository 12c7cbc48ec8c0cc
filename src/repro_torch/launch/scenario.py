"""Scenario simulation command line of the port: run a registered traffic
pattern open-loop, or sweep it (port of ``repro/launch/scenario.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.scenario --list
  PYTHONPATH=src python -m repro_torch.launch.scenario --device cpu \
      --scenario gemv_allreduce -p flag_delays_ns=20000 --engines cycle,event,vector
  PYTHONPATH=src python -m repro_torch.launch.scenario --scenario gemv_allreduce \
      --sweep flag_delays_ns=0,8000 --sweep n_egpus=3,7 --csv sweep.csv

``-p/--param key=value`` sets a scenario constructor parameter or a SimConfig
field for a single run; ``--sweep key=v1,v2,...`` builds a grid handled by
:class:`repro_torch.core.scenario.SweepRunner` (config fields and scenario
params are told apart automatically).  Values are parsed as Python literals
when possible, else kept as strings.  ``--devices N`` sets the total device
count.

The vector engine's tensors live on ``--device``: the CUDA device by default
(an error without a card), ``cpu`` for the host.  The reference's closed-loop
flags (``--detailed all``, ``--nodes``, ``--fabric``, ``--link``,
``--ici-bw``, ``--dci-bw``, ``--list-fabrics``, ``--verify``,
``--prove-layout``, ``--sanitize``) are not ported yet: they exit 1 with an
error naming them.
"""

from __future__ import annotations

import argparse
import ast
import sys
from typing import Dict, List

from ..core import (EngineKind, SimConfig, SweepRunner, SyncPolicy, get_scenario,
                    list_scenarios, simulate)
from ..core.scenario import SIM_CONFIG_FIELDS
from ..device import resolve_device

__all__ = ["main"]

# the reference's flags that belong to the closed loop, which is not ported
# yet: each is refused with an error naming it (``--detailed 0``, the open
# loop, is accepted)
CLOSED_LOOP_FLAGS = ("--detailed", "--nodes", "--fabric", "--link", "--ici-bw", "--dci-bw",
                     "--list-fabrics", "--verify", "--prove-layout", "--sanitize")


def _literal(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _split_top_level(text: str) -> List[str]:
    """Split on commas not nested in (), [] or {} — so sweep values may be
    tuples/lists, e.g. ``flag_delays_ns=(0,8000),(0,16000)``."""
    out, buf, depth = [], [], 0
    for ch in text:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    out.append("".join(buf))
    return out


def _parse_kv(pairs: List[str], *, split_values: bool = False) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"error: expected key=value, got {pair!r}")
        key, _, val = pair.partition("=")
        if split_values:
            out[key] = [_literal(v) for v in _split_top_level(val)]
        else:
            out[key] = _literal(val)
    return out


def _closed_loop_flags(args) -> List[str]:
    """The closed-loop flags the command line was given."""
    given = {flag: getattr(args, flag[2:].replace("-", "_")) for flag in CLOSED_LOOP_FLAGS}
    return [flag for flag, value in given.items()
            if value is not None and not (flag == "--detailed" and value == "0")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.scenario", description=__doc__.splitlines()[0]
    )
    ap.add_argument("--scenario", default="gemv_allreduce",
                    help="registered scenario name (see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--engine", default="event",
                    choices=[e.value for e in EngineKind])
    ap.add_argument("--engines", default=None,
                    help="comma-separated engine list (sweeps run each)")
    ap.add_argument("--sync", default="spin",
                    choices=[s.value for s in SyncPolicy])
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="total device count (sets n_egpus = N - 1)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="torch device of the vector engine (default: the "
                         "CUDA device; an error without one)")
    ap.add_argument("-p", "--param", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="scenario parameter or SimConfig override")
    ap.add_argument("--sweep", action="append", default=[],
                    metavar="KEY=V1,V2,...",
                    help="sweep a parameter over a list of values")
    ap.add_argument("--csv", default=None,
                    help="write sweep results to this CSV file")
    for flag in CLOSED_LOOP_FLAGS:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help="closed loop: not ported yet")
    args = ap.parse_args(argv)

    closed = _closed_loop_flags(args)
    if closed:
        raise SystemExit(
            f"error: {', '.join(closed)}: the closed loop (every device "
            "detailed, fabrics, the static verifier, the layout prover and "
            "the sanitizer) is not ported yet"
        )

    if args.list:
        for name in list_scenarios():
            cls = get_scenario(name)
            doc = (cls.__doc__ or cls.__module__).strip().splitlines()[0]
            print(f"{name:18s} {doc}")
        return 0

    try:
        device = resolve_device(args.device)
        get_scenario(args.scenario)
    except (KeyError, RuntimeError) as e:
        raise SystemExit(f"error: {e.args[0]}")

    engines = [
        EngineKind(e)
        for e in (args.engines.split(",") if args.engines else [args.engine])
    ]
    params = _parse_kv(args.param)
    cfg_over = {k: v for k, v in params.items() if k in SIM_CONFIG_FIELDS}
    sc_params = {k: v for k, v in params.items() if k not in SIM_CONFIG_FIELDS}
    try:
        base_cfg = SimConfig(sync=SyncPolicy(args.sync), **cfg_over)
        if args.devices is not None:
            base_cfg = base_cfg.with_devices(args.devices)
    except ValueError as e:
        raise SystemExit(f"error: {e}")

    if args.sweep:
        grid = _parse_kv(args.sweep, split_values=True)
        runner = SweepRunner(args.scenario, base_cfg, engines=engines, device=device)
        # non-swept scenario params become single-value grid axes
        grid.update({k: [v] for k, v in sc_params.items()})
        try:
            points = runner.run(grid)
        except (NotImplementedError, TypeError, ValueError) as e:
            raise SystemExit(f"error: {e}")
        csv = SweepRunner.to_csv(points)
        print(csv)
        if args.csv:
            with open(args.csv, "w") as f:
                f.write(csv + "\n")
            print(f"# wrote {len(points)} rows to {args.csv}", file=sys.stderr)
        return 0

    for eng in engines:
        cfg = base_cfg.with_(engine=eng)
        try:
            report = simulate(args.scenario, cfg, collect_segments=False, device=device,
                              **sc_params)
        except (NotImplementedError, TypeError, ValueError) as e:
            raise SystemExit(f"error: {e}")
        print(report.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
