"""The port's Mamba2 block and zamba2-2.7b against ``repro.models.ssm`` and
the reference's hybrid model.

Inputs are made with numpy from a seed and handed to both sides; the block's
parameters are the reference's ``materialize`` draws, carried across.
``mamba_apply`` (output and final state) and a ``mamba_decode`` sequence that
continues from the prefill state follow the reference, in float32 and bf16.
The bf16 pins hold bit for bit against the reference's own ops: the prefill
conv rounds after every tap's multiply and add, as XLA does on the CPU,
while decode sums the taps in float32 over a float32 window.  Then zamba2's
reduced config end to end through :func:`test_torch_families.check_arch`
(6 entries: two Mamba groups, each followed by the one shared block), its
full-width walk of 63 cache entries against the reference's abstract
caches, and ``ServeEngine``'s greedy tokens and stats.

Tolerances: float32 3e-5 (the reference's ``_tol``); bf16 3e-2 (its bf16
``_tol``): XLA rounds the SiLU gate's sigmoid op by op in bf16 where
``F.silu`` rounds once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_families import DTYPES, TOL, _pair, arch_cases, check_arch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.models.common import materialize as jmaterialize
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.models import ssm
from repro_torch.models.model import init_caches, layer_blocks
from repro_torch.serving import ServeConfig, ServeEngine

ARCH = "zamba2-2.7b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _mamba_params(dtype, seed=0):
    jd, td = DTYPES[dtype]
    jcfg = jreduced(jget_config(ARCH)).with_(param_dtype=jd)
    tcfg = reduced(get_config(ARCH)).with_(param_dtype=td)
    jp = jmaterialize(jssm.mamba_specs(jcfg), jax.random.PRNGKey(seed))
    # a_log, d_skip, dt_bias and norm_z start at constants: draw them so the
    # test sees each term of the recurrence
    rng = np.random.default_rng(seed)
    for name in ("a_log", "dt_bias", "norm_z"):
        jp[name] = jnp.asarray(rng.standard_normal(jp[name].shape) * 0.5).astype(jp[name].dtype)
    jp["d_skip"] = jnp.asarray(rng.random(jp["d_skip"].shape) + 0.5).astype(jnp.float32)
    specs = ssm.mamba_specs(tcfg)
    assert sorted(specs) == sorted(jp)
    tp = {k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(specs[k].dtype)
          for k, v in jp.items()}
    for k, s in specs.items():
        assert tuple(tp[k].shape) == s.shape == jp[k].shape and str(tp[k].dtype) == (
            f"torch.{jp[k].dtype}")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba_apply_and_decode_match_reference(dtype):
    jcfg, tcfg, jp, tp = _mamba_params(dtype)
    B, S, steps = 2, 13, 6
    u = np.random.default_rng(1).standard_normal((B, S + steps, tcfg.d_model))
    ju, tu = _both(u, dtype)
    jy, jstate = jssm.mamba_apply(jcfg, jp, ju[:, :S], return_state=True)
    y, state = ssm.mamba_apply(tcfg, tp, tu[:, :S], return_state=True)
    assert y.dtype == tu.dtype and y.shape == (B, S, tcfg.d_model)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype], err_msg="prefill output")
    np.testing.assert_allclose(_np(ssm.mamba_apply(tcfg, tp, tu[:, :S])), _np(y), rtol=0, atol=0)
    assert sorted(state) == sorted(jstate) == ["conv", "h"]
    for name in state:
        assert state[name].dtype == torch.float32 and tuple(state[name].shape) == (
            jstate[name].shape)
        np.testing.assert_allclose(_np(state[name]), _np(jstate[name]), **TOL[dtype],
                                   err_msg=f"prefill state {name}")
    jdecode = jax.jit(lambda p, x, st: jssm.mamba_decode(jcfg, p, x, st))
    for t in range(S, S + steps):
        jy, jstate = jdecode(jp, ju[:, t:t + 1], jstate)
        y, state2 = ssm.mamba_decode(tcfg, tp, tu[:, t:t + 1], state)
        assert state2 is state  # updated in place
        np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype], err_msg=f"decode step {t}")
        for name in state:
            assert state[name].dtype == torch.float32
            np.testing.assert_allclose(_np(state[name]), _np(jstate[name]), **TOL[dtype],
                                       err_msg=f"decode state {name} at step {t}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba_decode_from_zero_state_is_the_prefill_token_by_token(dtype):
    # in float32 the two paths compute the same function; in bf16 the
    # prefill conv rounds each tap in bf16 and decode does not, as in the
    # reference, so they agree only to the bf16 tolerance
    _, tcfg, _, tp = _mamba_params(dtype, seed=2)
    u = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 9, tcfg.d_model))).to(
        DTYPES[dtype][1])
    y = ssm.mamba_apply(tcfg, tp, u)
    state = ssm.init_ssm_state(tcfg, 2, torch.device("cpu"))
    ys = [ssm.mamba_decode(tcfg, tp, u[:, t:t + 1], state)[0] for t in range(9)]
    np.testing.assert_allclose(_np(torch.cat(ys, dim=1)), _np(y), **TOL[dtype])


def test_causal_conv_rounds_each_tap_in_the_activation_dtype_as_the_reference():
    rng = np.random.default_rng(4)
    jx, tx = _both(rng.standard_normal((2, 20, 96)), "bfloat16")
    jw, tw = _both(rng.standard_normal((4, 96)) * 0.5, "bfloat16")
    pre = ssm._causal_conv(tx, tw)
    want = jssm._causal_conv(jx, jw)
    np.testing.assert_allclose(_np(pre), _np(want), **TOL["bfloat16"])
    # the sum before the SiLU is the reference's, bit for bit
    K = 4
    pad = jnp.pad(jx, ((0, 0), (K - 1, 0), (0, 0)))
    out = jnp.zeros_like(jx)
    for i in range(K):
        out = out + pad[:, i:i + 20, :] * jw[i][None, None, :]
    tpad = F.pad(tx, (0, 0, K - 1, 0))
    tout = torch.zeros_like(tx)
    for i in range(K):
        tout = tout + tpad[:, i:i + 20] * tw[i]
    assert np.array_equal(_np(tout), _np(out))
    assert torch.equal(ssm._causal_conv(tx, tw), F.silu(tout))


def test_init_ssm_state_is_float32_zeros_of_the_reference_shapes():
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    want = jssm.init_ssm_state(jcfg, 3)
    got = ssm.init_ssm_state(tcfg, 3, torch.device("meta"))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    assert got["h"].shape == (3, 80, 64, 64) and got["conv"].shape == (3, 3, 5248)


def test_full_width_cache_walk_has_the_reference_63_entries():
    jmodel, cfg = JModel(jget_config(ARCH)), get_config(ARCH)
    entries = layer_blocks(cfg)
    assert [b for b, _ in entries] == [b for b, _, _ in jmodel._layer_blocks()]
    assert len(entries) == 63 and sum(shared for _, shared in entries) == 9
    assert [i for i, (_, shared) in enumerate(entries) if shared] == list(range(6, 63, 7))
    caches = init_caches(cfg, 4, 544, torch.device("meta"))
    jcaches = jmodel.abstract_caches(4, 544)
    assert len(caches) == len(jcaches) == 63
    for li, (c, jc) in enumerate(zip(caches, jcaches)):
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in c.items()} == {
            k: (v.shape, f"torch.{v.dtype}") for k, v in jc.items()}, li
    nbytes = [sum(v.numel() * v.element_size() for v in c.values()) for c in caches]
    # 54 SSM states (h: 4 x 80 x 64 x 64 float32) and 9 KV caches (4 x 544 x 32 x 80 bf16)
    assert sum(nbytes) == 54 * (4 * 80 * 64 * 64 + 4 * 3 * 5248) * 4 + 9 * 2 * 4 * 544 * 2560 * 2


@pytest.mark.parametrize("arch,dtype,with_embeds", list(arch_cases([ARCH])))
def test_zamba2_forward_prefill_and_decode_match_reference(arch, dtype, with_embeds,
                                                           monkeypatch):
    check_arch(arch, dtype, with_embeds, monkeypatch)


def test_zamba2_keeps_the_shared_block_once():
    _, _, model = _pair(ARCH, "float32")
    names = list(model.state_dict())
    assert sum(n.startswith("shared.") for n in names) == 9  # ln1, 4 attention, ln2, 3 mlp
    assert not any(n.startswith("blocks.") and ".attn." in n for n in names)
    assert len(model.blocks) == 4 and len(model.entries) == 6
    assert model.entries[2] is model.entries[5] is model.shared


def test_zamba2_engine_serves_greedy_tokens_and_stats_as_the_reference():
    jmodel, jparams, model = _pair(ARCH, "float32")
    prompts = [[5, 6, 7], [9, 10], [1, 2, 3, 4],
               [int(t) for t in np.random.default_rng(1).integers(1, 256, 11)]]
    jeng = JServeEngine(jmodel, jparams, JServeConfig(max_batch=2))
    eng = ServeEngine(model, ServeConfig(max_batch=2))
    jouts, outs = jeng.generate(prompts, 6), eng.generate(prompts, 6)
    assert outs == [[int(t) for t in o] for o in jouts]
    # the port also counts its reads of the device: one a decode step, one a batch of 2
    syncs = jeng.stats["decode_steps"] + jeng.stats["requests"] // 2
    assert eng.stats == {**jeng.stats, "host_syncs": syncs}
