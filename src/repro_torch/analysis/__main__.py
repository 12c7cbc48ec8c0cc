"""Verify every registered scenario against every fabric preset (port of
``repro/analysis/__main__.py``; ``--device`` picks where the timeline stage's
simulations run: the CUDA device by default, ``cpu`` for the host).

The CI gate: ``python -m repro_torch.analysis`` statically checks all built-in
(and any registered) scenarios on the flat fabric and on each interconnect
preset, without running a single simulated cycle.  Exits non-zero if any
combination produces an error-severity finding.

It then dynamically verifies the pod-scale **timeline engine path**
(``repro_torch.core.cohort_timeline``): every closed-loop scenario x preset runs
once at small scale through both the event engine and the timeline engine,
and their traffic counters must match bit-for-bit.  A scenario may be
timeline-ineligible only by *declaring why* (a ``timeline_opt_out`` reason
string on the scenario class); an undeclared ineligibility is a failure —
pod-scale coverage must never rot silently.  ``--no-timeline`` skips this
stage (static-only runs).

Finally it verifies **symbolic programs in loop space**: every closed-loop
scenario whose ranks stamp :class:`repro_torch.core.scenario.SymbolicProgram`\\ s
is checked at ``--pod-devices`` scale (default 1024) with one node per
(lane, affine pattern) — O(segments), never the O(devices x steps) sites a
materialized lowering would need — and the loop-space verdict is
cross-checked against the materialized verifier at ``--devices`` scale.
Non-rank-uniform scenarios (e.g. hierarchical stages) are reported as
covered by the materialized path.  ``--no-symbolic`` skips the stage.

Last, the **parametric layout prover** (:mod:`repro_torch.analysis.layout`)
certifies every closed-loop scenario's flag/marker address layout for *all*
device counts up to ``--max-devices`` (default 4096) on the flat shape and
re-attests each fabric preset — flag pool / partial region / marker-window
disjointness, unique flag writers per value epoch, and wait-before-emit
ordering, without expanding a single program.  ``--no-layout`` skips it.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.core.interconnect import list_fabrics
from repro_torch.core.scenario import list_scenarios

from .verify import verify_scenario

# the physics outputs the timeline engine must reproduce bit-for-bit
_TIMELINE_KEYS = (
    "flag_reads",
    "nonflag_reads",
    "local_writes",
    "xgmi_writes_in",
    "xgmi_writes_out",
    "xgmi_bytes_in",
    "xgmi_bytes_out",
    "read_bytes",
    "write_bytes",
)


def _verify_timeline_path(devices: int, dpn: int, quiet: bool, device=None) -> int:
    """Run every closed-loop scenario x fabric preset through both engine
    implementations and compare counters.  Returns the failure count."""
    from repro_torch.core import simulate
    from repro_torch.core.scenario import get_scenario

    failures = 0
    combos = 0
    for name in list_scenarios():
        for fabric in [None, *list_fabrics()]:
            kw = dict(
                devices=devices, closed_loop=True, collect_segments=False,
                device=device,
            )
            if fabric is not None:
                kw.update(fabric=fabric, devices_per_node=dpn)
            try:
                a = simulate(name, timeline=False, **kw)
            except TypeError:
                break  # open-loop-only scenario: no timeline path to verify
            combos += 1
            where = f"{name} [{fabric or 'flat'}]"
            try:
                b = simulate(name, timeline=True, **kw)
            except ValueError as e:
                declared = getattr(
                    get_scenario(name), "timeline_opt_out", None
                )
                if declared:
                    if not quiet:
                        print(f"{where}: timeline opt-out declared: "
                              f"{declared}")
                    continue
                failures += 1
                print(f"{where}: FAIL timeline-ineligible without a "
                      f"declared timeline_opt_out: {e}")
                continue
            if b.meta.get("engine_impl") != "timeline":
                failures += 1
                print(f"{where}: FAIL timeline engine did not engage "
                      f"(engine_impl={b.meta.get('engine_impl')!r})")
                continue
            drift = [
                f"{k} {a.traffic.get(k)} != {b.traffic.get(k)}"
                for k in _TIMELINE_KEYS
                if a.traffic.get(k) != b.traffic.get(k)
            ]
            if a.sim_cycles != b.sim_cycles:
                drift.append(f"sim_cycles {a.sim_cycles} != {b.sim_cycles}")
            if drift:
                failures += 1
                print(f"{where}: FAIL timeline counters drifted: "
                      + "; ".join(drift))
            elif not quiet:
                print(f"{where}: timeline path ok")
    tag = "FAILED" if failures else "ok"
    print(f"verified {combos} timeline-path combinations: {tag}"
          + (f" ({failures} with errors)" if failures else ""))
    return failures


def _verify_symbolic_path(
    small_devices: int, pod_devices: int, quiet: bool
) -> int:
    """Loop-space verification at pod scale + materialized cross-check at
    small scale.  Returns the failure count."""
    from .verify import verify_scenario, verify_symbolic

    failures = 0
    combos = 0
    for name in list_scenarios():
        try:
            v = verify_symbolic(name, devices=pod_devices, closed_loop=True)
        except TypeError:
            continue  # open-loop-only scenario
        combos += 1
        shape = [f for f in v.findings if f.kind == "symbolic-shape"]
        if shape:
            if not quiet:
                print(f"{name}: symbolic verify n/a (materialized path "
                      f"covers it): {shape[0].message}")
            continue
        if not v.ok:
            failures += 1
            print(v.render())
            continue
        # the loop-space verdict must agree with the exact per-step graph
        # at a scale where materializing is affordable
        vm = verify_scenario(name, devices=small_devices, closed_loop=True)
        vs = verify_symbolic(name, devices=small_devices, closed_loop=True)
        if vs.ok != vm.ok:
            failures += 1
            print(f"{name}: FAIL loop-space verdict ({'ok' if vs.ok else 'error'}) "
                  f"disagrees with the materialized verifier "
                  f"({'ok' if vm.ok else 'error'}) at {small_devices} devices")
        elif not quiet:
            print(f"{name}: symbolic loop-space verify ok at {pod_devices} "
                  f"devices (cross-checked at {small_devices})")
    tag = "FAILED" if failures else "ok"
    print(f"verified {combos} symbolic-program combinations: {tag}"
          + (f" ({failures} with errors)" if failures else ""))
    return failures


def _verify_layout_path(
    max_devices: int, dpn: int, quiet: bool
) -> int:
    """Parametric layout proofs over the closed-loop registry x fabric
    presets — every device count up to ``max_devices``, no simulation.
    Returns the failure count."""
    from .layout import prove_registry

    failures = 0
    proofs = prove_registry(
        max_devices=max_devices, devices_per_node=dpn, quiet=quiet
    )
    for proof in proofs:
        if not proof.ok:
            failures += 1
            print(proof.render())
        elif not quiet:
            print(proof.render())
    tag = "FAILED" if failures else "ok"
    print(f"proved {len(proofs)} layout obligations (registry x fabrics, "
          f"all n <= {max_devices}): {tag}"
          + (f" ({failures} with errors)" if failures else ""))
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="statically verify all scenarios x all fabric presets",
    )
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--devices-per-node", type=int, default=2)
    ap.add_argument(
        "-q", "--quiet", action="store_true",
        help="print only failing combinations",
    )
    ap.add_argument(
        "--no-timeline", action="store_true",
        help="skip the dynamic timeline-engine verification stage",
    )
    ap.add_argument(
        "--pod-devices", type=int, default=1024,
        help="device count for the loop-space symbolic verification stage",
    )
    ap.add_argument(
        "--no-symbolic", action="store_true",
        help="skip the loop-space symbolic verification stage",
    )
    ap.add_argument(
        "--max-devices", type=int, default=4096,
        help="device-count bound for the parametric layout-proof stage",
    )
    ap.add_argument(
        "--layout-dpn", type=int, default=4,
        help="devices-per-node used by the layout-proof stage",
    )
    ap.add_argument(
        "--no-layout", action="store_true",
        help="skip the parametric layout-proof stage",
    )
    ap.add_argument(
        "--device", default=None, choices=["cuda", "cpu"],
        help="torch device of the timeline stage's simulations (default: "
             "the CUDA device; an error without one)",
    )
    args = ap.parse_args(argv)

    failures = 0
    combos = 0
    for name in list_scenarios():
        for fabric in [None, *list_fabrics()]:
            params = {"closed_loop": True}
            if fabric is not None:
                params["fabric"] = fabric
            try:
                verdict = verify_scenario(
                    name,
                    devices=args.devices,
                    devices_per_node=args.devices_per_node,
                    **params,
                )
            except TypeError:
                # open-loop-only scenario (no closed_loop/fabric knobs):
                # verify its single modeled rank once, without presets
                if fabric is not None:
                    continue
                verdict = verify_scenario(name, devices=args.devices)
            combos += 1
            if not verdict.ok:
                failures += 1
            if not verdict.ok or not args.quiet:
                print(verdict.render())
    tag = "FAILED" if failures else "ok"
    print(f"verified {combos} scenario x fabric combinations: {tag}"
          + (f" ({failures} with errors)" if failures else ""))
    if not args.no_timeline:
        failures += _verify_timeline_path(
            args.devices, args.devices_per_node, args.quiet, args.device
        )
    if not args.no_symbolic:
        failures += _verify_symbolic_path(
            args.devices, args.pod_devices, args.quiet
        )
    if not args.no_layout:
        failures += _verify_layout_path(
            args.max_devices, args.layout_dpn, args.quiet
        )
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
