"""``mamba_decode_roofline``'s reader on made-up traces: its bytes at the
cell's shapes, and that it reads only where every Mamba2 layer of every step
took one ``mamba_decode`` launch."""

import importlib.util
import json

import pytest

from conftest import ROOT
from portbench import cost, peaks
from portbench.cells import Observed
from portbench.trace import Trace

KIND = "NVIDIA H100 80GB HBM3"


def _reader():
    path = ROOT / "portbench" / "metrics" / "mamba_decode_roofline.py"
    spec = importlib.util.spec_from_file_location("mamba_decode_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zamba2() -> dict:
    return json.loads((ROOT / "portbench" / "configs" / "zamba2-2.7b.json").read_text())["model"]


def _observed(kernels, steps=2, batch=512) -> Observed:
    tr = Trace((0, 10**9), [(name, i * 10, d) for i, (name, d) in enumerate(kernels)], [],
               len(kernels), [])
    return Observed(model=_zamba2(), traffic={}, kind=KIND, prompt_lens=[32] * batch,
                    steps=steps, stats={}, trace=tr)


def test_bytes_of_a_launch_at_the_cells_shapes():
    """zamba2-2.7b at B 512: the 1,342 MB state and the 64.5 MB window each
    read and written, the projection read and the gated y written."""
    flops, nbytes = _reader().mamba_decode_cost(_zamba2(), 512)
    assert nbytes == 1_422_659_520
    assert flops == 512 * (2 * 4 * 5248 + 5 * 5120 * 64)


def test_reads_the_bound_over_the_kernels_time():
    """Every launch taking twice its bound reads 50%; other kernels are
    not counted."""
    bound = peaks.bound_s(KIND, *_reader().mamba_decode_cost(_zamba2(), 512))
    layers = cost.blocks(_zamba2()).count("mamba")
    assert layers == 54
    dur = round(2 * bound * 1e9)
    kernels = [("void (anonymous namespace)::mamba_decode_kernel<__nv_bfloat16, 64>", dur)] \
        * (2 * layers) + [("void rmsnorm_kernel<bf16, 2>", 5_000)]
    assert _reader().read(_observed(kernels)) == pytest.approx(50.0, rel=1e-6)


@pytest.mark.parametrize("launches", [0, 2 * 54 - 1, 2 * 54 + 1])
def test_reads_nothing_unless_one_launch_a_layer_and_step(launches):
    kernels = [("void (anonymous namespace)::mamba_decode_kernel<__nv_bfloat16, 64>", 400_000)]
    kernels = kernels * launches + [("elementwise_kernel", 1_000)]
    assert _reader().read(_observed(kernels)) is None
