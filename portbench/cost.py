"""Operations and bytes that a model's work needs, from its configuration
and the cell's shapes: the yardstick of the roofline and ``mfu`` readers.

A FLOP is a multiply or an add (a multiply-add is 2).  Bytes count each
input read once and each output written once, at the width the served
model keeps them (bfloat16: 2 bytes), and only what these inputs need:
attention reads the filled slots of the cache, not its length.
"""

from __future__ import annotations

from typing import Iterable, List

ACT_BYTES = 2  # bfloat16 activations, caches and weights


def blocks(m: dict) -> List[str]:
    """The blocks one step applies, in order: ``"attn_mlp"``, ``"attn_moe"``
    or ``"mamba"`` (a shared block counts each time it is applied)."""
    L = m["n_layers"]
    if m.get("family") == "hybrid":
        every, out, done = m["attn_block_every"], [], 0
        while done < L:
            n = min(every, L - done)
            out += ["mamba"] * n
            done += n
            if done < L or n == every:
                out.append("attn_mlp")
        return out
    if m.get("n_experts", 0):
        dense = m.get("first_dense_layers", 0)
        return ["attn_mlp"] * dense + ["attn_moe"] * (L - dense)
    return ["attn_mlp"] * L


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def attention_flops(m: dict, ctx: int) -> int:
    """One token's attention over ``ctx`` slots: its projections, the scores
    and the weighted sum of values."""
    d, H, KV, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], _hd(m)
    return 2 * d * hd * (2 * H + 2 * KV) + 4 * H * hd * ctx


def mamba_flops(m: dict) -> int:
    """One token through a Mamba2 mixer: the two projections, the 4-tap
    conv, the state's decay and update (3 a state entry) and its read (2)."""
    d, ds, K = m["d_model"], m["ssm_state"], m["ssm_conv"]
    d_inner = m["ssm_expand"] * d
    heads = max(1, d_inner // 64)
    cols = 2 * d_inner + 2 * ds + heads
    state = d_inner * ds
    return 2 * d * cols + 2 * K * (d_inner + 2 * ds) + 5 * state + 2 * d_inner * d


def token_flops(m: dict, ctx: int) -> int:
    """One token's forward, attending ``ctx`` slots, through every block and
    the head (norms and other elementwise work left out)."""
    d, ff = m["d_model"], m["d_ff"]
    total = 2 * d * m["vocab"]
    for kind in blocks(m):
        if kind == "mamba":
            total += mamba_flops(m)
            continue
        total += attention_flops(m, ctx)
        if kind == "attn_moe":
            total += 2 * d * m["n_experts"] + m["experts_per_token"] * 6 * d * ff
        else:
            total += 6 * d * ff
    return total


def served_flops(m: dict, prompt_lens: Iterable[int], new_tokens: int) -> int:
    """The model's FLOPs for requests of these prompt lengths, each with
    ``new_tokens`` new tokens: every real token that feeds a prediction (the
    prompt and all but the last new token), at its own context, padding
    left out."""
    fixed = token_flops(m, 0)
    per_slot = token_flops(m, 1) - fixed  # token_flops is linear in ctx
    total = 0
    for p in prompt_lens:
        n = p + new_tokens - 1  # contexts 1..n
        total += n * fixed + per_slot * n * (n + 1) // 2
    return total


def attention_launches(m: dict) -> int:
    """Attention blocks a step applies."""
    return sum(kind != "mamba" for kind in blocks(m))


def norms_per_step(m: dict) -> int:
    """RMSNorms a step applies: two an attention block, one a Mamba2 layer,
    and the final one."""
    return 1 + sum(1 if kind == "mamba" else 2 for kind in blocks(m))


def decode_attention_cost(m: dict, batch: int, length: int) -> tuple:
    """``(FLOPs, bytes)`` of one token's attention for ``batch`` rows over
    ``length`` filled slots: the query, each row's filled keys and values,
    the output."""
    H, KV, hd = m["n_heads"], m["n_kv_heads"], _hd(m)
    nbytes = ACT_BYTES * batch * (2 * H * hd + 2 * length * KV * hd)
    return 4 * batch * H * hd * length, nbytes


def rmsnorm_cost(m: dict, batch: int) -> tuple:
    """``(FLOPs, bytes)`` of one RMSNorm of ``batch`` rows of ``d_model``:
    x read, the gain read, y written."""
    d = m["d_model"]
    return 4 * batch * d, ACT_BYTES * (2 * batch * d + d)
