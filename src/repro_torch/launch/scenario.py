"""Scenario simulation command line of the port: run any registered traffic
pattern, or sweep it (port of ``repro/launch/scenario.py``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.scenario --list
  PYTHONPATH=src python -m repro_torch.launch.scenario --device cpu \
      --scenario gemv_allreduce -p flag_delays_ns=20000 --engines cycle,event,vector
  PYTHONPATH=src python -m repro_torch.launch.scenario --device cpu \
      --scenario all_to_all --sweep skew_ns=0,2000,8000 --sweep n_egpus=3,7 --csv sweep.csv
  PYTHONPATH=src python -m repro_torch.launch.scenario --device cpu \
      --scenario ring_allreduce --devices 8 --detailed all
  PYTHONPATH=src python -m repro_torch.launch.scenario --device cpu \
      --scenario hierarchical_allreduce --devices 16 --nodes 4 \
      --dci-bw 6.25 --detailed all
  PYTHONPATH=src python -m repro_torch.launch.scenario --device cpu \
      --scenario all_to_all --devices 16 --nodes 4 --detailed all --fabric rail_optimized
  PYTHONPATH=src python -m repro_torch.launch.scenario --device cpu \
      --scenario ring_allreduce --devices 8 --nodes 4 --detailed all \
      --fabric fat_tree --link spine=3.125
  PYTHONPATH=src python -m repro_torch.launch.scenario --device cpu \
      --scenario ring_allreduce --devices 8 --detailed all --verify
  PYTHONPATH=src python -m repro_torch.launch.scenario --device cpu \
      --scenario all_to_all --devices 8 --detailed all --sanitize

``-p key=value`` sets one scenario parameter or SimConfig field;
``--sweep key=v1,v2,...`` sweeps it (repeatable; the cross product runs via
:class:`repro_torch.core.scenario.SweepRunner` (config fields and scenario
params are told apart automatically).  Values are parsed as Python literals
when possible, else kept as strings.

``--devices N`` sets the total device count; ``--detailed all`` promotes every
device to a program-driven detailed device in one closed simulation loop
(``closed_loop=True`` — flags are emitted over the fabric instead of
pre-scheduled), while the default ``--detailed 0`` keeps the open-loop
single-detailed-device replay.

``--nodes K`` splits the devices into K nodes (``devices_per_node = N / K``):
intra-node hops ride the ICI tier, inter-node hops the per-node DCI uplinks.
``--fabric NAME`` selects a registered interconnect preset (``ring``,
``two_tier``, ``fat_tree``, ``rail_optimized``, ``torus2d`` — see
``--list-fabrics``) for the closed-loop fabric; ``--link CLASS=GBPS``
overrides one link class's bandwidth (repeatable; unknown classes raise an
error listing the fabric's valid ones).  ``--ici-bw`` / ``--dci-bw`` remain
as aliases for ``--link ici=…`` / ``--link dci=…`` (and additionally scale
the open-loop arrival schedules derived from the hardware model).

The vector engine's and the lockstep solvers' tensors live on ``--device``:
the CUDA device by default (an error without a card), ``cpu`` for the host.
``--verify`` and ``--prove-layout`` run the static analyzer
(:mod:`repro_torch.analysis`) instead of simulating; ``--sanitize`` runs the
traffic sanitizer alongside the closed-loop engines.
"""

from __future__ import annotations

import argparse
import ast
import sys
from typing import Dict, List

from ..core import (
    EngineKind,
    SimConfig,
    SweepRunner,
    SyncPolicy,
    get_fabric,
    get_scenario,
    list_fabrics,
    list_scenarios,
    simulate,
)
from ..core.scenario import SIM_CONFIG_FIELDS
from ..device import resolve_device

__all__ = ["main"]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.scenario", description=__doc__.splitlines()[0]
    )
    ap.add_argument("--scenario", default="gemv_allreduce",
                    help="registered scenario name (see --list)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--list-fabrics", action="store_true",
                    help="list registered interconnect presets and exit")
    ap.add_argument("--engine", default="event",
                    choices=[e.value for e in EngineKind])
    ap.add_argument("--engines", default=None,
                    help="comma-separated engine list (sweeps run each)")
    ap.add_argument("--sync", default="spin",
                    choices=[s.value for s in SyncPolicy])
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="total device count (sets n_egpus = N - 1)")
    ap.add_argument("--nodes", type=int, default=None, metavar="K",
                    help="group the devices into K nodes (devices_per_node = "
                         "N / K); intra-node traffic rides ICI, inter-node "
                         "traffic the per-node DCI uplinks")
    ap.add_argument("--fabric", default=None, metavar="NAME",
                    help="interconnect preset for the closed-loop fabric "
                         "(see --list-fabrics)")
    ap.add_argument("--link", action="append", default=[],
                    metavar="CLASS=GBPS",
                    help="override one link class's bandwidth in GB/s "
                         "(repeatable, e.g. --link spine=3.125); unknown "
                         "classes raise an error listing valid ones")
    ap.add_argument("--ici-bw", type=float, default=None, metavar="GBPS",
                    help="intra-node (ICI) link bandwidth override, GB/s "
                         "(alias for --link ici=GBPS; also scales open-loop "
                         "arrival schedules)")
    ap.add_argument("--dci-bw", type=float, default=None, metavar="GBPS",
                    help="inter-node (DCI) link bandwidth override, GB/s "
                         "(alias for --link dci=GBPS; also scales open-loop "
                         "arrival schedules)")
    ap.add_argument("--detailed", default="0", choices=["0", "all"],
                    help="'all': closed-loop cluster, every device detailed; "
                         "'0': open-loop replay with one detailed device")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="torch device of the vector engine and the "
                         "lockstep solvers (default: the CUDA device; an "
                         "error without one)")
    ap.add_argument("--verify", action="store_true",
                    help="statically verify the scenario's phase programs "
                         "(deadlock cycles, unmatched sync, slot races, "
                         "fabric reachability) instead of simulating; exits "
                         "non-zero with the diagnosis on a broken program")
    ap.add_argument("--prove-layout", action="store_true",
                    help="run the parametric layout prover instead of "
                         "simulating: certify flag/partial/marker "
                         "disjointness, unique flag writers, and wait/emit "
                         "ordering for ALL device counts up to the "
                         "scenario's max_devices bound (or --devices when "
                         "given); exits non-zero with the finding and the "
                         "smallest failing device count on a broken layout")
    ap.add_argument("--sanitize", action="store_true",
                    help="run the traffic sanitizer alongside the engines "
                         "(byte conservation, calendar monotonicity, "
                         "exactly-once flag delivery); requires "
                         "--detailed all")
    ap.add_argument("-p", "--param", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="scenario parameter or SimConfig override")
    ap.add_argument("--sweep", action="append", default=[],
                    metavar="KEY=V1,V2,...",
                    help="sweep a parameter over a list of values")
    ap.add_argument("--csv", default=None,
                    help="write sweep results to this CSV file")
    args = ap.parse_args(argv)

    if args.list:
        for name in list_scenarios():
            cls = get_scenario(name)
            doc = (cls.__doc__ or cls.__module__).strip().splitlines()[0]
            print(f"{name:18s} {doc}")
        return 0

    if args.list_fabrics:
        for name in list_fabrics():
            builder = get_fabric(name)
            doc = " ".join(
                (builder.__doc__ or builder.__module__).strip().split()
            )
            print(f"{name:16s} {doc}")
        return 0

    try:
        get_scenario(args.scenario)
        device = resolve_device(args.device)
    except (KeyError, RuntimeError) as e:
        raise SystemExit(f"error: {e.args[0]}")
    if args.fabric is not None:
        try:
            get_fabric(args.fabric)
        except KeyError as e:
            raise SystemExit(f"error: {e.args[0]}")

    engines = [
        EngineKind(e)
        for e in (args.engines.split(",") if args.engines else [args.engine])
    ]
    params = _parse_kv(args.param)
    cfg_over = {k: v for k, v in params.items() if k in SIM_CONFIG_FIELDS}
    sc_params = {k: v for k, v in params.items() if k not in SIM_CONFIG_FIELDS}
    if args.detailed == "all":
        sc_params["closed_loop"] = True
    if args.nodes is not None:
        if args.devices is None or args.devices % args.nodes:
            raise SystemExit(
                f"error: --nodes {args.nodes} needs --devices divisible by it"
            )
        sc_params.setdefault("devices_per_node", args.devices // args.nodes)
    if args.fabric is not None:
        sc_params.setdefault("fabric", args.fabric)
    # per-link-class bandwidth overrides (GB/s == bytes/ns); these flow
    # through InterconnectSpec.with_link_overrides, which *validates* the
    # class names against the fabric instead of silently ignoring them
    link_bw: Dict[str, float] = {}
    for pair in args.link:
        key, sep, val = pair.partition("=")
        if not sep:
            raise SystemExit(f"error: expected --link CLASS=GBPS, got {pair!r}")
        try:
            link_bw[key] = float(val)
        except ValueError:
            raise SystemExit(
                f"error: --link {key} needs a numeric GB/s value, got {val!r}"
            )
    if args.ici_bw is not None:
        link_bw.setdefault("ici", args.ici_bw)
    if args.dci_bw is not None:
        link_bw.setdefault("dci", args.dci_bw)
    if link_bw:
        sc_params.setdefault("link_bw", link_bw)
    if args.ici_bw is not None or args.dci_bw is not None:
        # the legacy aliases also scale the hardware model, so open-loop
        # arrival schedules (derived from hw, not the fabric) shift too
        from dataclasses import replace as _replace

        from ..core.topology import V5E

        hw = sc_params.get("hw", V5E)
        if args.ici_bw is not None:
            hw = _replace(hw, ici_link_bw=args.ici_bw * 1e9)
        if args.dci_bw is not None:
            hw = _replace(hw, dci_link_bw=args.dci_bw * 1e9)
        sc_params["hw"] = hw
    try:
        base_cfg = SimConfig(sync=SyncPolicy(args.sync), **cfg_over)
        if args.devices is not None:
            base_cfg = base_cfg.with_devices(args.devices)
    except ValueError as e:
        raise SystemExit(f"error: {e}")

    if args.verify:
        from ..analysis import verify_scenario

        try:
            verdict = verify_scenario(args.scenario, base_cfg, **sc_params)
        except (NotImplementedError, TypeError, ValueError) as e:
            raise SystemExit(f"error: {e}")
        print(verdict.render())
        return 0 if verdict.ok else 1

    if args.prove_layout:
        from ..analysis import prove_layout

        pl_params = dict(sc_params)
        pl_params.pop("closed_loop", None)
        try:
            proof = prove_layout(
                args.scenario,
                devices_per_node=pl_params.pop("devices_per_node", None),
                fabric=pl_params.pop("fabric", None),
                max_devices=args.devices,
                **pl_params,
            )
        except (NotImplementedError, TypeError, ValueError) as e:
            raise SystemExit(f"error: {e}")
        print(proof.render())
        return 0 if proof.ok else 1

    if args.sanitize and args.detailed != "all":
        raise SystemExit(
            "error: --sanitize requires --detailed all (the sanitizer "
            "shadows the closed-loop cluster)"
        )

    if args.sweep:
        grid = _parse_kv(args.sweep, split_values=True)
        runner = SweepRunner(args.scenario, base_cfg, engines=engines, device=device)
        if sc_params:
            # non-swept scenario params become single-value grid axes
            grid.update({k: [v] for k, v in sc_params.items()})
        try:
            points = runner.run(grid)
        except KeyError as e:  # unknown fabric/scenario via -p or --sweep
            raise SystemExit(f"error: {e.args[0]}")
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
            report = simulate(args.scenario, cfg, collect_segments=False,
                              sanitize=args.sanitize, device=device, **sc_params)
        except KeyError as e:  # unknown fabric preset via -p fabric=...
            raise SystemExit(f"error: {e.args[0]}")
        except (NotImplementedError, TypeError, ValueError) as e:
            raise SystemExit(f"error: {e}")
        print(report.summary())
        if report.closed_loop:
            print(report.device_summary())
            ps = report.meta.get("program_stats")
            if ps:
                impl = ("lockstep" if ps.get("lockstep")
                        else report.meta.get("engine_impl", "?"))
                print(
                    f"programs: {ps['symbolic_programs']} symbolic / "
                    f"{ps['flat_programs']} flat | "
                    f"{ps['program_phases']} phases "
                    f"({ps['materialized_phases']} materialized, "
                    f"{ps['segments']} segments) | "
                    f"built in {ps['construct_wall_s'] * 1e3:.1f} ms | "
                    f"advanced by {impl}"
                )
            reason = report.meta.get("lockstep_reason")
            if reason:
                print(f"lockstep: {reason}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
