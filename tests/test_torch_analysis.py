"""The port's static analyzer (``repro_torch.analysis``) against the
reference's (``repro.analysis``), exactly.

The analyzer is host code over Python ints, ``Fraction`` values and numpy,
copied whole; these tests hold its every output to the reference's on the
same inputs:

- ``verify_scenario`` verdicts for every registered scenario on the flat
  fabric and every preset (8 devices, 2 a node), rendered text included, and
  ``verify_symbolic`` at 64 devices;
- the layout prover: ``prove_layout`` of every closed-loop scenario,
  ``prove_registry``, and seeded layout faults (the legacy hierarchical map,
  a duplicated emitter) blamed with the same counts, slots and messages, and
  ``check_programs``' findings on them;
- ``diagnose_deadlock``'s blame text on deadlocking programs;
- the traffic sanitizer clean on a sanitized run, and raising the same
  ``SanitizerError`` on each planted fault;
- the gate, ``python -m repro_torch.analysis``, printing the reference's
  lines at reduced ``--max-devices`` / ``--pod-devices``.
"""

import contextlib
import dataclasses
import io

import pytest

import repro.analysis as RA
import repro.core as R
import repro.core.scenario as RS
import repro_torch.analysis as PA
import repro_torch.core as P
import repro_torch.core.scenario as PS
from repro.analysis import __main__ as ref_gate
from repro_torch.analysis import __main__ as port_gate

PKGS = ((R, RA), (P, PA))
SCENARIO = {R: RS, P: PS}
FABRICS = (None, "ring", "two_tier", "fat_tree", "rail_optimized", "torus2d")
CLOSED_LOOP = ("ring_allreduce", "all_to_all", "pipeline_p2p", "hierarchical_allreduce")


def _dev(M) -> dict:
    return {"device": "cpu"} if M is P else {}


def _findings(fs) -> list:
    return [dataclasses.asdict(f) for f in fs]


def test_registries_agree():
    assert P.list_scenarios() == R.list_scenarios()
    assert P.list_fabrics() == R.list_fabrics()
    assert P.verify_scenario is PA.verify_scenario  # the lazy re-export


@pytest.mark.parametrize("name", sorted(R.list_scenarios()))
def test_verdicts_equal_the_reference(name):
    for fabric in FABRICS:
        params = {"closed_loop": True, **({"fabric": fabric} if fabric else {})}
        out = []
        for _M, A in PKGS:
            try:
                v = A.verify_scenario(name, devices=8, devices_per_node=2, **params)
            except TypeError as e:  # open-loop only: verified once, without presets
                out.append(("TypeError", str(e), A.verify_scenario(name, devices=8).render()))
                continue
            out.append((v.ok, v.render(), _findings(v.findings)))
        assert out[1] == out[0], (name, fabric)


@pytest.mark.parametrize("name", sorted(R.list_scenarios()))
def test_symbolic_verdicts_equal_the_reference(name):
    out = []
    for _M, A in PKGS:
        try:
            v = A.verify.verify_symbolic(name, devices=64, closed_loop=True)
        except TypeError as e:
            out.append(str(e))
            continue
        out.append((v.ok, v.render()))
    assert out[1] == out[0]


@pytest.mark.parametrize("name", CLOSED_LOOP)
def test_layout_proofs_equal_the_reference(name):
    proofs = [A.prove_layout(name, devices_per_node=4, max_devices=128) for _M, A in PKGS]
    assert proofs[1].render() == proofs[0].render()
    assert _findings(proofs[1].findings) == _findings(proofs[0].findings)
    assert proofs[1].checked_counts == proofs[0].checked_counts and proofs[1].ok


def test_prove_registry_equals_the_reference():
    got = [[p.render() for p in A.prove_registry(max_devices=64, devices_per_node=4,
                                                  quiet=True)] for _M, A in PKGS]
    assert got[1] == got[0] and len(got[1]) >= 20


def _legacy_hierarchical(M):
    base = M.get_scenario("hierarchical_allreduce")

    class Legacy(base):
        """hierarchical_allreduce with the shrunk-gap (legacy) address map."""

        def __init__(self, cfg, amap=None, **kw):
            n = cfg.n_devices
            dpn = kw.get("devices_per_node") or n
            amap = M.AddressMap(n_devices=n, flag_slots=dpn + 2 * (n // dpn - 1) + 1)
            super().__init__(cfg, amap, **kw)

    return Legacy


def _duplicated_emitter(M):
    base = M.get_scenario("all_to_all")
    S = SCENARIO[M]

    class Duplicated(base):
        """all_to_all with one extra emission of an already-written flag."""

        def _symbolic_phases(self, rank, *, emit):
            prog = super()._symbolic_phases(rank, emit=emit)
            if not emit:
                return prog
            n = self.cfg.n_devices
            dup = S.PhaseSpec("a2a_dispatch", 1,
                              emits=(S.EmitOp((rank + 1) % n, slot=0, payload_bytes=8),))
            return S.SymbolicProgram(prog.segments + (dup,), group=prog.group)

    return Duplicated


@pytest.mark.parametrize("fault", ("legacy_map", "duplicated_emitter"))
def test_seeded_layout_faults_blamed_as_the_reference(fault):
    proofs, checks = [], []
    for M, A in PKGS:
        if fault == "legacy_map":
            cls, kw = _legacy_hierarchical(M), dict(devices_per_node=2, max_devices=512)
        else:
            cls, kw = _duplicated_emitter(M), dict(max_devices=64)
        proofs.append(A.prove_layout(cls, **kw))
        cfg = M.SimConfig(workgroups=4).with_devices(16)
        sc = cls(cfg, closed_loop=True, devices_per_node=4, fabric="two_tier")
        progs = [SCENARIO[M].as_symbolic(sc.programs_for(d)[0].phases)
                 for d in range(cfg.n_devices)]
        checks.append(_findings(A.check_programs(progs, sc.amap, cfg)))
    assert not proofs[1].ok
    assert proofs[1].render() == proofs[0].render()
    assert _findings(proofs[1].findings) == _findings(proofs[0].findings)
    assert checks[1] == checks[0]


def _silent_ring(M):
    base = M.get_scenario("ring_allreduce")

    class Silent(base):
        """ring_allreduce whose ranks wait on every step's flag but never
        emit one."""

        name = "silent_ring"

        def programs_for(self, device):
            return self.programs()

    return Silent


def test_diagnose_deadlock_equals_the_reference():
    texts = []
    for M, A in PKGS:
        cfg = M.SimConfig(workgroups=4).with_devices(4)
        texts.append(A.diagnose_deadlock(_silent_ring(M)(cfg, closed_loop=True)))
        ok = M.get_scenario("ring_allreduce")(cfg, closed_loop=True)
        texts.append(A.diagnose_deadlock(ok))
    assert texts[2:] == texts[:2]
    assert texts[0].startswith("static analysis:\n") and texts[1] is None


def _small_cluster(M, **kw):
    cfg = M.SimConfig(engine=M.EngineKind.EVENT, workgroups=8).with_devices(4)
    sc = M.get_scenario("ring_allreduce")(cfg, closed_loop=True, devices_per_node=2,
                                          fabric="two_tier")
    return M.Cluster(cfg, sc, sanitize=True, collect_segments=False, **_dev(M), **kw), sc


@pytest.mark.parametrize("fault", ("clean", "bytes", "flag", "unit"))
def test_sanitizer_equals_the_reference(fault):
    out = []
    for M, A in PKGS:
        if fault == "unit":
            fm = M.FabricModel(4)
            amap = M.AddressMap(n_devices=4)
            san = A.TrafficSanitizer(amap, fm, 4)
            san.note_emission(0, 1, amap.flag_addr(0), 8, 100.0, 50.0)  # acausal
            obs = san.observer_for(1)
            obs(amap.flag_addr(0), 1, 8, 10)
            obs(amap.flag_addr(0), 1, 8, 5)  # the calendar runs backwards
            run = san.check
        else:
            cluster, sc = _small_cluster(M)
            if fault == "bytes":
                cluster.fabric.stats["bytes"] += 1
            elif fault == "flag":
                key = (1, sc.amap.flag_addr(0, slot=0))
                cluster._san.expected_flags[key] = cluster._san.expected_flags.get(key, 0) + 1
            run = cluster.run
        if fault == "clean":
            report = run()
            out.append((report.meta["sanitized"], report.meta["lockstep_reason"],
                        report.flag_reads, report.sim_cycles))
            continue
        with pytest.raises(A.SanitizerError) as err:
            run()
        out.append(str(err.value))
    assert out[1] == out[0]
    if fault == "clean":
        assert out[1][:2] == (True, "traffic sanitization observes individual write enactments")
    else:
        want = {"bytes": "byte conservation", "flag": "flag delivery", "unit": "acausal"}[fault]
        assert want in out[1]


def test_gate_prints_the_reference_lines():
    argv = ["-q", "--devices", "4", "--pod-devices", "32", "--max-devices", "32"]
    outs = []
    for main, extra in ((ref_gate.main, []), (port_gate.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = main([*argv, *extra])
        outs.append((code, buf.getvalue()))
    assert outs[1] == outs[0]
    lines = outs[1][1].splitlines()
    assert outs[1][0] == 0 and len(lines) == 4 and all(line.endswith(": ok") for line in lines)
