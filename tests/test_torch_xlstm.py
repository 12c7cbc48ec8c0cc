"""The port's mLSTM and sLSTM cells and xlstm-125m against
``repro.models.xlstm`` and the reference's ssm-family model.

Inputs are made with numpy from a seed and handed to both sides; the cells'
parameters are the reference's ``materialize`` draws, carried across.  Each
cell's ``*_apply`` (output and final state) and a ``*_decode`` sequence that
continues from that state follow the reference, in float32 and bf16; the
initial states keep the reference's pins (mLSTM's ``m`` at -1e30, sLSTM's
``n`` at 1, all float32).  Then xlstm-125m's reduced config (pattern
``mmms``) end to end through :func:`test_torch_families.check_arch`, and
``ServeEngine``'s greedy tokens and stats.

Tolerances: float32 3e-5 (the reference's ``_tol``); bf16 3e-2 (its bf16
``_tol``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import DTYPES, TOL, _pair, arch_cases, check_arch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import xlstm as jxlstm
from repro.models.common import materialize as jmaterialize
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.models import xlstm
from repro_torch.serving import ServeConfig, ServeEngine

ARCH = "xlstm-125m"
CELLS = {"mlstm": ("mlstm_specs", "mlstm_apply", "mlstm_decode", "init_mlstm_state"),
         "slstm": ("slstm_specs", "slstm_apply", "slstm_decode", "init_slstm_state")}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _cell(cell, dtype, seed=0):
    jd, td = DTYPES[dtype]
    jcfg = jreduced(jget_config(ARCH)).with_(param_dtype=jd)
    tcfg = reduced(get_config(ARCH)).with_(param_dtype=td)
    specs_fn = CELLS[cell][0]
    jp = jmaterialize(getattr(jxlstm, specs_fn)(jcfg), jax.random.PRNGKey(seed))
    specs = getattr(xlstm, specs_fn)(tcfg)
    assert sorted(specs) == sorted(jp)
    tp = {k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(specs[k].dtype)
          for k, v in jp.items()}
    for k, s in specs.items():
        assert tuple(tp[k].shape) == s.shape == jp[k].shape and str(tp[k].dtype) == (
            f"torch.{jp[k].dtype}")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cell_apply_and_decode_match_reference(cell, dtype):
    jcfg, tcfg, jp, tp = _cell(cell, dtype)
    _, apply, decode, _ = CELLS[cell]
    B, S, steps = 2, 11, 6
    # inputs at the scale of a normed residual stream, so the exponential
    # gates both saturate and stay inside their stabiliser
    x = np.random.default_rng(1).standard_normal((B, S + steps, tcfg.d_model)) * 2.0
    jx, tx = _both(x, dtype)
    jy, jstate = getattr(jxlstm, apply)(jcfg, jp, jx[:, :S], return_state=True)
    y, state = getattr(xlstm, apply)(tcfg, tp, tx[:, :S], return_state=True)
    assert y.dtype == tx.dtype and y.shape == (B, S, tcfg.d_model)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype], err_msg="apply output")
    assert torch.equal(getattr(xlstm, apply)(tcfg, tp, tx[:, :S]), y)
    assert sorted(state) == sorted(jstate)
    for name in state:
        assert state[name].dtype == torch.float32
        np.testing.assert_allclose(_np(state[name]), _np(jstate[name]), **TOL[dtype],
                                   err_msg=f"apply state {name}")
    jdecode = jax.jit(lambda p, xx, st: getattr(jxlstm, decode)(jcfg, p, xx, st))
    for t in range(S, S + steps):
        jy, jstate = jdecode(jp, jx[:, t:t + 1], jstate)
        y, state2 = getattr(xlstm, decode)(tcfg, tp, tx[:, t:t + 1], state)
        assert state2 is state  # updated in place
        np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype], err_msg=f"decode step {t}")
        for name in state:
            np.testing.assert_allclose(_np(state[name]), _np(jstate[name]), **TOL[dtype],
                                       err_msg=f"decode state {name} at step {t}")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_init_states_keep_the_reference_pins(cell):
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    init = CELLS[cell][3]
    want = getattr(jxlstm, init)(jcfg, 3)
    got = getattr(xlstm, init)(tcfg, 3, torch.device("cpu"))
    assert sorted(got) == sorted(want)
    for name in got:
        assert got[name].dtype == torch.float32
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))
    if cell == "mlstm":
        assert torch.equal(got["m"], torch.full((3, 4), -1e30))
        assert got["C"].shape == (3, 4, 192, 192)
    else:
        assert got["n"].unique().tolist() == [1.0]


def test_mlstm_gate_product_is_float32_on_bf16_activations():
    _, tcfg, _, tp = _cell("mlstm", "bfloat16")
    assert tp["w_if"].dtype == torch.float32 and tp["w_q"].dtype == torch.bfloat16
    x_m = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, tcfg.d_model))).to(
        torch.bfloat16)
    q, k, v, ig, fg = xlstm._mlstm_gates(tcfg, tp, x_m)
    assert all(t.dtype == torch.float32 for t in (q, k, v, ig, fg))
    gif = x_m.float() @ tp["w_if"]
    assert torch.equal(ig, gif[..., 0::2]) and torch.equal(fg, gif[..., 1::2])


@pytest.mark.parametrize("arch,dtype,with_embeds", list(arch_cases([ARCH])))
def test_xlstm_forward_prefill_and_decode_match_reference(arch, dtype, with_embeds,
                                                          monkeypatch):
    check_arch(arch, dtype, with_embeds, monkeypatch)


def test_xlstm_engine_serves_greedy_tokens_and_stats_as_the_reference():
    jmodel, jparams, model = _pair(ARCH, "float32")
    assert [b.kind for b in model.entries] == ["xlstm_m", "xlstm_m", "xlstm_m", "xlstm_s"]
    prompts = [[5, 6, 7], [9, 10], [1, 2, 3, 4],
               [int(t) for t in np.random.default_rng(1).integers(1, 256, 11)]]
    jeng = JServeEngine(jmodel, jparams, JServeConfig(max_batch=2))
    eng = ServeEngine(model, ServeConfig(max_batch=2))
    jouts, outs = jeng.generate(prompts, 6), eng.generate(prompts, 6)
    assert outs == [[int(t) for t in o] for o in jouts]
    # the port also counts its reads of the device: one a decode step, one a batch of 2
    syncs = jeng.stats["decode_steps"] + jeng.stats["requests"] // 2
    assert eng.stats == {**jeng.stats, "host_syncs": syncs}
