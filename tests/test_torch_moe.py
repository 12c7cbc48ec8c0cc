"""The port's MoE layer against the reference's ``repro.models.moe``.

Inputs are made with numpy from a seed and handed to both sides.  The
router's top-k indices must be identical (a tie, two experts of one equal
probability, picks the lower index first, as ``jax.lax.top_k`` does); the
stable expert sort must give ``jnp.argsort``'s order; the grouped FFN is held
to ``ragged_dot`` with empty groups among the experts; ``moe_apply`` to the
reference with its aux losses, for olmoe's plan and for kimi-k2's with a
shared expert.  Then olmoe-1b-7b and kimi-k2-1t-a32b end to end through
:func:`test_torch_families.check_arch`.

Tolerances: float32 3e-5 (the reference's ``_tol``); bf16 3e-2 (its bf16
``_tol``): the products round at the same places, in sums of other orders.
Indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import DTYPES, TOL, arch_cases, check_arch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import moe as jmoe
from repro.models.common import materialize as jmaterialize
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe

MOE_ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _configs(arch, dtype="float32"):
    jd, td = DTYPES[dtype]
    return (jreduced(jget_config(arch)).with_(param_dtype=jd),
            reduced(get_config(arch)).with_(param_dtype=td))


def _params(jcfg, seed=0):
    """The reference's MoE parameters and the same values as torch tensors."""
    jp = jmaterialize(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed))
    tp = {}
    for k, v in jp.items():
        a = np.asarray(v)
        t = torch.from_numpy(a.astype(np.float32))
        tp[k] = t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t
    return jp, tp


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_indices_weights_and_losses_match_reference(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg)
    jx, tx = _x((64, tcfg.d_model), "float32")
    jidx, jw, jaux = jmoe._router(jcfg, jp, jx)
    idx, w, aux = moe.route(tcfg, tp, tx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL["float32"])
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        np.testing.assert_allclose(_np(aux[k]), _np(jaux[k]), **TOL["float32"], err_msg=k)
    assert moe.route(tcfg, tp, tx, aux=False)[2] == {}


def test_router_breaks_an_exact_tie_toward_the_lower_index():
    jcfg, tcfg = _configs("olmoe-1b-7b")  # 8 experts, top-2
    jp, tp = _params(jcfg)
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 2]  # experts 2 and 5 score alike on every token
    router[:, 2] += 5.0 * np.sign(router[:, 2])  # and above the rest on x = sign(w)
    router[:, 5] = router[:, 2]
    x = np.stack([np.sign(router[:, 2]), -np.sign(router[:, 2])]).astype(np.float32)
    jidx, _, _ = jmoe._router(jcfg, {"router": jnp.asarray(router)}, jnp.asarray(x))
    idx, w, _ = moe.route(tcfg, {"router": torch.from_numpy(router)}, torch.from_numpy(x))
    assert idx[0].tolist() == [2, 5] == np.asarray(jidx)[0].tolist()
    assert w[0, 0] == w[0, 1]  # an exact tie
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_expert_sort_is_stable_as_jnp_argsort():
    flat = np.random.default_rng(2).integers(0, 8, 96)
    order = torch.argsort(torch.from_numpy(flat), stable=True)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jnp.argsort(jnp.asarray(flat))))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_grouped_ffn_matches_ragged_dot_with_empty_groups(dtype):
    jcfg, tcfg = _configs("olmoe-1b-7b", dtype)
    jp, tp = _params(jcfg)
    sizes = np.array([3, 0, 5, 0, 0, 7, 1, 0], np.int32)  # experts 1, 3, 4, 7 get no rows
    jx, tx = _x((int(sizes.sum()), tcfg.d_model), dtype)
    jy = jmoe._grouped_ffn(jcfg, jp, jx, jnp.asarray(sizes))
    y = moe.grouped_ffn(tcfg, tp, tx, torch.from_numpy(np.cumsum(sizes).astype(np.int32)))
    assert y.dtype == tx.dtype and y.shape == tx.shape
    np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype])


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_apply_matches_reference_with_aux_losses(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    assert bool(tcfg.n_shared_experts) == (arch == "kimi-k2-1t-a32b")
    jp, tp = _params(jcfg)
    jx, tx = _x((2, 9, tcfg.d_model), dtype)
    jy, jaux = jmoe.moe_apply(jcfg, jp, jx)
    y, aux, idx = moe.moe_apply(tcfg, tp, tx)
    assert y.dtype == tx.dtype and idx.shape == (18, tcfg.experts_per_token)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL[dtype])
    for k in jaux:
        np.testing.assert_allclose(_np(aux[k]), _np(jaux[k]), **TOL[dtype], err_msg=k)
    if dtype == "float32":
        jidx, _, _ = jmoe._router(jcfg, jp, jx.reshape(-1, tcfg.d_model))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("arch,dtype,with_embeds", list(arch_cases(MOE_ARCHS)))
def test_moe_archs_forward_prefill_and_decode_match_reference(arch, dtype, with_embeds,
                                                              monkeypatch):
    check_arch(arch, dtype, with_embeds, monkeypatch)
