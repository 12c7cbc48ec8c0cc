"""The plain reference against the port's reduced olmoe and zamba2 on the
CPU, and the comparison that decides ``correct``: a sound run passes it and
the float8 control fails it (the faults are in test_portbench_faults.py)."""

import pytest
import torch

from conftest import CONFIGS, TINY_LIMITS, tiny_cell_name
from portbench import cells, oracle, run, traffic, weights

CPU = torch.device("cpu")


def _serve(cell, seed, m=None):
    """The cell's first batch through the engine and the probe: ``(batch as
    the oracle takes it, weights, the logits of every step [B, steps, V])``."""
    from repro_torch.models import Model
    from repro_torch.serving import ServeConfig, ServeEngine

    m, mix = m or cell.model, cell.traffic
    model = Model(run.model_config(m), device=CPU)
    w = weights.draw(cell.reference.params(m), seed, CPU)
    model.load_state_dict(w, strict=True)
    seen, inner = [], model.decode_step

    def step(caches, tok, pos, **kw):
        logits, caches = inner(caches, tok, pos, **kw)
        seen.append(logits.clone())
        return logits, caches

    model.decode_step = step
    probe = run.Probe(model, CPU, cell.config.get("state_dtype", {}))
    prompts = traffic.batch(mix, m["vocab"], seed, 0)
    rows = oracle.sample_rows(prompts, seed, 0, cell.limits["sample_requests"])
    outs, gaps, kept = probe.batch(ServeEngine(model, ServeConfig(max_batch=mix["batch"])),
                                   prompts, mix["new_tokens"], rows)
    assert len(gaps) == mix["new_tokens"] - 1
    return ({"prompts": prompts, "outs": outs, "rows": rows, "logits": kept,
             "state_dtypes": probe.state_dtypes}, w, torch.stack(seen, 1))


@pytest.mark.parametrize("head_dim", [16, 32], ids=["d_over_heads", "wider_heads"])
@pytest.mark.parametrize("config", CONFIGS)
def test_reference_is_the_port_in_float32(tiny_root, config, head_dim):
    """In float32 the port's logits at every step of a served batch, padding
    included, are the reference's full forward pass over the same sequence,
    and the probe keeps the steps' logits that chose the new tokens; also
    with heads wider than d_model / heads, as zamba2's 32 heads of 160."""
    cell = cells.load(tiny_root, tiny_cell_name(config))
    m = {**cell.model, "param_dtype": "float32", "head_dim": head_dim}
    batch, w, seen = _serve(cell, 11, m)
    every = {**batch, "rows": list(range(len(batch["prompts"])))}
    tokens, first, served = oracle.sequences([every], cell.traffic["new_tokens"])
    with torch.no_grad():
        ref = cell.reference.logits(m, w, tokens)
    T = tokens.shape[1]
    assert (seen[:, :T] - ref).abs().max().item() < 1e-5 * ref.abs().max().item() + 1e-6
    new = cell.traffic["new_tokens"]
    assert torch.equal(batch["logits"], seen[batch["rows"], first[0]:first[0] + new])
    at = oracle.reference_logits(cell.reference, m, w, tokens, first, new)
    assert oracle.gaps(at, served).max().item() < 1e-5  # float32 greedy: the reference's best


@pytest.mark.parametrize("config", CONFIGS)
def test_control_fails_where_the_program_passes(tiny_root, config):
    """The served bfloat16 program reads under the tiny cell's limit; the
    float8 control over the same sequences reads above it, on three seeds."""
    cell = cells.load(tiny_root, tiny_cell_name(config))
    for seed in (1, 2, 3):
        batch, _, _ = _serve(cell, seed)
        read = oracle.readings(cell, seed, [batch], CPU)
        control = oracle.control(cell, seed, [batch], CPU)["fp8"]
        assert read["served_not_greedy"] == 0 and read["malformed_outputs"] == 0
        number, limit = TINY_LIMITS[config]
        assert read[number] <= limit < control[number], (read, control)
        assert oracle.is_correct(oracle.checks(cell, read))
        assert not oracle.is_correct(oracle.checks(cell, {**read, **control}))


def test_sample_rows_hold_the_longest_and_every_stretch():
    prompts = [[1] * n for n in (3, 4, 9, 5, 6, 7, 2, 8)]
    rows = oracle.sample_rows(prompts, 5, 0, 4)
    assert rows[0] == 2 and len(rows) == 4
    assert sorted(r // 2 for r in rows) == [0, 1, 2, 3]  # one row from each pair
    assert oracle.sample_rows(prompts, 5, 0, 4) == rows
    assert oracle.sample_rows(prompts[:3], 5, 0, 4) == [2, 0, 1]


def test_sequences_put_the_engines_padding_back():
    batch = {"prompts": [[5, 6], [1, 2, 3, 4]], "outs": [[5, 6, 7, 8, 9], [1, 2, 3, 4, 7, 7, 7]],
             "rows": [1, 0]}
    tokens, first, served = oracle.sequences([batch], 3)
    assert tokens.tolist() == [[1, 2, 3, 4, 7, 7], [0, 0, 5, 6, 7, 8]]
    assert first == [3, 3] and served.tolist() == [[7, 7, 7], [7, 8, 9]]


def test_malformed_counts_wrong_outputs():
    assert oracle.malformed([[4, 5]], [[4, 5, 1, 2]], 2, 10) == 0
    assert oracle.malformed([[4, 5]], [[4, 5, 1]], 2, 10) == 1      # a token short
    assert oracle.malformed([[4, 5]], [[4, 6, 1, 2]], 2, 10) == 1   # the prompt altered
    assert oracle.malformed([[4, 5]], [[4, 5, 1, 12]], 2, 10) == 1  # an id outside vocab


def test_logit_err_is_the_worst_rows_median():
    ref = torch.ones(2, 3, 4)
    off = ref.clone()
    off[0, 0] *= 2      # one position of row 0 far off: its median stays 0
    off[1] *= 1.1       # every position of row 1 off by 10%
    assert oracle.logit_err(off, ref) == pytest.approx(0.1)
    assert oracle.logit_err_max(off, ref) == pytest.approx(1.0)  # the far-off position


def test_state_dtype_mismatch_counts_tensors_held_otherwise():
    stated = {"h": "float32", "conv": "float32"}
    sound = {"h:float32": 3, "conv:float32": 3}
    assert oracle.state_dtype_mismatch(stated, [sound, sound]) == 0
    assert oracle.state_dtype_mismatch(stated, [sound, {"h:bfloat16": 3, "conv:float32": 3}]) == 3
    assert oracle.state_dtype_mismatch(stated, [{"h:float32": 3}]) == 1  # conv held nowhere
    assert oracle.state_dtype_mismatch(stated, []) == 2


def test_the_controls_follow_what_the_configuration_states(tiny_root):
    """float8 below bfloat16 everywhere; a bfloat16 state below zamba2's
    stated float32 state, and the reference rounds that state at every step."""
    zamba = cells.load(tiny_root, tiny_cell_name("zamba2-2.7b"))
    olmoe = cells.load(tiny_root, tiny_cell_name("olmoe-1b-7b"))
    assert oracle.controls(olmoe) == ["fp8"]
    assert oracle.controls(zamba) == ["fp8", "bf16_state"]
    m = zamba.model
    w = weights.draw(zamba.reference.params(m), 3, CPU)
    tokens = torch.tensor(traffic.batch({**zamba.traffic, "batch": 2, "prompt_len": [10, 10]},
                                        m["vocab"], 3, 0))
    ref = oracle.reference_logits(zamba.reference, m, w, tokens, [0, 0], tokens.shape[1])
    low = oracle.reference_logits(zamba.reference, m, w, tokens, [0, 0], tokens.shape[1],
                                  "bf16_state")
    assert 0 < oracle.logit_err_max(low, ref) < 0.05
