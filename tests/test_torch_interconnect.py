"""The port's fabric gallery, Topology helpers and FabricModel against the
reference's, exactly.

Every preset (``ring``, ``two_tier``, ``fat_tree``, ``rail_optimized``,
``torus2d``) is built on both sides from the same shape and seeded random
parameters; the port's spec (link classes, declared ports, node shape) and
its whole route table (every pair's legs: class, port, hops, endpoints) must
equal the reference's.  ``FabricModel.transfer`` and ``transfer_batch`` then
price the same seeded random message streams on both sides: every arrival
time, ``stats`` and ``port_stats`` (floats included) must be equal, and the
batched pricing must equal the sequential one as it does in the reference.
"""

import dataclasses
import random

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core import interconnect as ref_ic
from repro_torch.core import interconnect as port_ic

PRESETS = ("ring", "two_tier", "fat_tree", "rail_optimized", "torus2d")
# (devices, devices per node): flat, two-node, many-node and one-device nodes
SHAPES = ((8, None), (8, 4), (16, 4), (12, 3), (16, 1))


def _params(name: str, n: int, dpn, rng: random.Random) -> dict:
    """Seeded random preset parameters (the reference's _spec_for draws)."""
    if name == "fat_tree":
        return {"oversubscription": rng.choice([1.0, 2.0, 3.5, 8.0]),
                "nodes_per_leaf": rng.randint(1, 4)}
    if name == "rail_optimized":
        return {"rails": rng.randint(1, max(1, dpn or 1))}
    if name == "torus2d":
        return {"rows": rng.choice([d for d in range(1, n + 1) if n % d == 0])}
    return {}


def _specs(name: str, n: int, dpn, seed: int):
    params = _params(name, n, dpn, random.Random(seed))
    return (R.build_fabric(name, n, devices_per_node=dpn, **params),
            P.build_fabric(name, n, devices_per_node=dpn, **params))


def _spec_fields(spec) -> tuple:
    return (spec.name, spec.n_devices, spec.devices_per_node, spec.n_nodes,
            spec.nics_per_node, spec.params, spec.ports,
            {k: dataclasses.astuple(v) for k, v in spec.link_classes.items()},
            spec.describe(), type(spec.routing).__name__)


def _legs(table) -> dict:
    return {pair: [dataclasses.astuple(leg) for leg in legs] for pair, legs in table.items()}


def test_registry_and_hardware_equal_the_reference():
    assert P.list_fabrics() == R.list_fabrics() == sorted(PRESETS)
    for name in PRESETS:
        assert P.get_fabric(name).__doc__ == R.get_fabric(name).__doc__
    assert dataclasses.astuple(port_ic.V5E)[:-1] == dataclasses.astuple(ref_ic.V5E)
    with pytest.raises(KeyError, match="unknown fabric preset 'nope'"):
        P.get_fabric("nope")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", PRESETS)
def test_preset_specs_and_route_tables_equal_the_reference(name, shape):
    n, dpn = shape
    for seed in range(2):
        ref, port = _specs(name, n, dpn, seed)
        assert _spec_fields(port) == _spec_fields(ref)
        ref_fab, port_fab = R.FabricModel.from_spec(ref), P.FabricModel.from_spec(port)
        assert _legs(port_fab.route_table()) == _legs(ref_fab.route_table())
        assert len(port_fab.route_table()) == n * (n - 1)
        for src in range(n):
            for dst in range(n):
                if src != dst:
                    assert port_fab.route_legs(src, dst) == ref_fab.route_legs(src, dst)


def _stream(n: int, rng: np.random.Generator, count: int):
    """Seeded random messages: (src, dst, bytes, issue ns), issue times
    non-decreasing so that ports queue, with a few zero-byte bursts."""
    src = rng.integers(0, n, count)
    dst = (src + rng.integers(1, n, count)) % n
    nbytes = rng.integers(0, 1 << 16, count)
    nbytes[rng.random(count) < 0.05] = 0
    issue = np.cumsum(rng.exponential(400.0, count))
    return [(int(s), int(d), int(b), float(t)) for s, d, b, t in zip(src, dst, nbytes, issue)]


def _fabric_state(fab) -> tuple:
    return (dict(fab.stats), {k: list(v) for k, v in fab.port_stats.items()},
            dict(fab._busy_until_ns))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", PRESETS)
def test_transfer_and_batches_equal_the_reference(name, shape):
    n, dpn = shape
    rng = np.random.default_rng([PRESETS.index(name), n, dpn or 0])
    ref, port = (R.FabricModel.from_spec(s) for s in _specs(name, n, dpn, 1))
    for src, dst, nb, t in _stream(n, rng, 300):
        assert port.transfer(src, dst, nb, t) == ref.transfer(src, dst, nb, t)
    assert _fabric_state(port) == _fabric_state(ref)
    # batches of every size around the 16-burst threshold, one source each,
    # destinations in a random order with repeats
    for size in (1, 5, 15, 16, 17, 40):
        src = int(rng.integers(0, n))
        dsts = [int((src + d) % n) for d in rng.integers(1, n, size)]
        nbytes = [int(b) for b in rng.integers(0, 1 << 14, size)]
        t = float(rng.uniform(0, 2e5))
        assert port.transfer_batch(src, dsts, nbytes, t) == ref.transfer_batch(src, dsts, nbytes, t)
        assert _fabric_state(port) == _fabric_state(ref)
    # the batched pricing equals the sequential one (the reference's claim)
    seq = P.FabricModel.from_spec(port.spec)
    bat = P.FabricModel.from_spec(port.spec)
    src = 0
    dsts = [d for d in range(1, n)] * 2
    nbytes = [int(b) for b in rng.integers(1, 1 << 12, len(dsts))]
    want = [seq.transfer(src, d, b, 100.0) for d, b in zip(dsts, nbytes)]
    assert bat.transfer_batch(src, dsts, nbytes, 100.0) == want
    assert _fabric_state(bat) == _fabric_state(seq)


def test_topology_helpers_and_legacy_fabric_equal_the_reference():
    for n, dpn in ((8, None), (8, 8), (8, 2), (16, 4)):
        ref, port = R.Topology.for_devices(n, dpn), P.Topology.for_devices(n, dpn)
        assert (port.axis_sizes, port.axis_names, port.dci_axes, port.devices_per_node,
                port.n_nodes, port.describe()) == (ref.axis_sizes, ref.axis_names, ref.dci_axes,
                                                   ref.devices_per_node, ref.n_nodes,
                                                   ref.describe())
        r_fab, p_fab = R.FabricModel.from_topology(ref), P.FabricModel.from_topology(port)
        assert _spec_fields(p_fab.spec) == _spec_fields(r_fab.spec)
    legacy = dict(hop_latency_ns=100.0, link_bw_bytes_per_ns=2.0, dci_hop_latency_ns=900.0,
                  dci_link_bw_bytes_per_ns=0.5)
    r_fab, p_fab = R.FabricModel(8, devices_per_node=4, **legacy), \
        P.FabricModel(8, devices_per_node=4, **legacy)
    assert _spec_fields(p_fab.spec) == _spec_fields(r_fab.spec)
    assert p_fab.route(0, 3) == r_fab.route(0, 3)
    for M in (R, P):
        with pytest.raises(ValueError, match="crosses nodes"):
            M.FabricModel(8, devices_per_node=4).route(0, 5)


@pytest.mark.parametrize("case", ["unknown_class", "bad_override_key", "bad_shape",
                                  "spec_size"])
def test_fabric_errors_equal_the_reference(case):
    def call(M):
        if case == "unknown_class":
            return M.build_fabric("rail_optimized", 8, devices_per_node=4, link_bw={"dci": 5.0})
        if case == "bad_override_key":
            return M.FabricModel.from_topology(M.Topology.for_devices(8, 4), bogus=1.0)
        if case == "bad_shape":
            return M.FabricModel(8, devices_per_node=3)
        return M.interconnect.resolve_fabric(M.build_fabric("ring", 8), 16)

    msgs = []
    for M in (R, P):
        with pytest.raises(ValueError) as err:
            call(M)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
