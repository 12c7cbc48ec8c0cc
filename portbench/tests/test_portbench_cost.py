"""The benchmark's yardstick: its FLOP and byte functions against hand
counts at tiny shapes, its block plan against the program's own, the
peaks' bound, and the weights drawn from the seed."""

import pytest

from portbench import cost, peaks

MOE = {"family": "moe", "n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
       "head_dim": 4, "d_ff": 16, "vocab": 32, "n_experts": 4, "experts_per_token": 2}
HYBRID = {"family": "hybrid", "n_layers": 5, "attn_block_every": 2, "d_model": 8,
          "n_heads": 2, "n_kv_heads": 2, "d_ff": 16, "vocab": 32, "ssm_state": 4,
          "ssm_conv": 4, "ssm_expand": 2}


def test_attention_flops_by_hand():
    # q 2*8*8, k 2*8*4, v 2*8*4, o 2*8*8 = 384; scores and values 2 * 2*2*4*3 = 96
    assert cost.attention_flops(MOE, 3) == 384 + 96


def test_token_flops_by_hand():
    # head 2*8*32 = 512; a layer: attention 480, router 2*8*4 = 64, two experts 2*6*8*16 = 1536
    assert cost.token_flops(MOE, 3) == 512 + 2 * (480 + 64 + 1536)


def test_served_flops_sums_each_real_token_at_its_context():
    # a 2-token prompt and 3 new tokens: 4 tokens feed a prediction, contexts 1..4
    want = sum(cost.token_flops(MOE, ctx) for ctx in (1, 2, 3, 4))
    assert want == 4 * 4480 + 64 * 10
    assert cost.served_flops(MOE, [2], 3) == want
    assert cost.served_flops(MOE, [2, 5], 3) == want + sum(
        cost.token_flops(MOE, ctx) for ctx in range(1, 8))


def test_mamba_flops_by_hand():
    # d_inner 16, one head, W_in 2*8*(32+8+1), conv 2*4*24, state 5*16*4, W_out 2*16*8
    assert cost.mamba_flops(HYBRID) == 656 + 192 + 320 + 256


def test_hybrid_plan_counts_the_shared_block_each_time():
    assert cost.blocks(HYBRID) == ["mamba", "mamba", "attn_mlp", "mamba", "mamba", "attn_mlp",
                                   "mamba"]
    assert cost.blocks({**HYBRID, "n_layers": 6})[-1] == "attn_mlp"
    assert cost.attention_launches(HYBRID) == 2
    assert cost.norms_per_step(HYBRID) == 1 + 5 + 2 * 2
    assert cost.norms_per_step(MOE) == 5


def test_decode_attention_cost_counts_filled_slots():
    # 3 rows: q and out 2*4 each a head (2 heads), k and v 5 slots of one head of 4
    flops, nbytes = cost.decode_attention_cost(MOE, batch=3, length=5)
    assert flops == 4 * 3 * 2 * 4 * 5
    assert nbytes == 2 * 3 * (2 * 2 * 4 + 2 * 5 * 1 * 4)


def test_rmsnorm_cost_by_hand():
    assert cost.rmsnorm_cost(MOE, 3) == (4 * 3 * 8, 2 * (2 * 3 * 8 + 8))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-2.7b"])
def test_plan_and_launches_match_the_program(arch):
    """The cost model's blocks and kernel launches a step are the program's."""
    import json

    from conftest import ROOT
    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_launches, layer_blocks

    m = json.loads((ROOT / "portbench" / "configs" / f"{arch}.json").read_text())["model"]
    kinds = ["mamba" if b == "mamba" else "attn" for b, _ in layer_blocks(get_config(arch))]
    assert [k if k == "mamba" else "attn" for k in cost.blocks(m)] == kinds
    launches = decode_launches(get_config(arch))
    assert cost.norms_per_step(m) == launches["rmsnorm"]
    assert cost.attention_launches(m) == launches["decode_attention"]


def test_bound_is_the_larger_of_compute_and_bandwidth():
    kind = "NVIDIA H100 80GB HBM3"
    assert peaks.bound_s(kind, 989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(kind, 0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(kind, 989e9, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s("cpu", 1, 1) is None


def test_weights_follow_the_seed_and_their_kinds():
    """The same seed draws the same weights, another seed others; each
    kind has its range (Mamba2's decay and step as it initializes them)."""
    import torch

    from portbench import weights

    params = [("w", (64, 32), "bfloat16", "normal"), ("g", (32,), "bfloat16", "gain"),
              ("a", (4096,), "float32", "a_log"), ("dt", (4096,), "float32", "dt_bias"),
              ("d", (8,), "float32", "d_skip"), ("e", (16, 8), "bfloat16", "embed")]
    cpu = torch.device("cpu")
    one, again, other = (weights.draw(params, s, cpu) for s in (2**33 + 1, 2**33 + 1, 5))
    assert all(torch.equal(one[k], again[k]) for k in one)
    assert not torch.equal(one["w"], other["w"])
    assert one["w"].dtype == torch.bfloat16 and one["a"].dtype == torch.float32
    assert one["w"].float().std().item() == pytest.approx(64 ** -0.5, rel=0.1)
    assert one["e"].float().abs().max().item() < 0.02 * 6
    a = one["a"].exp()
    assert 1 <= a.min().item() and a.max().item() <= 16
    dt = torch.nn.functional.softplus(one["dt"])
    assert 1e-3 * 0.999 <= dt.min().item() and dt.max().item() <= 0.1 * 1.001
    with pytest.raises(ValueError, match="kind"):
        weights.draw([("x", (2,), "float32", "nope")], 1, cpu)
