"""OLMoE (arXiv:2409.02060) as the configuration file states it, in plain
float32: token embedding, pre-norm blocks of causal multi-head attention
with RoPE and a top-k mixture of SiLU-gated experts, a final norm and an
untied head.

Departures from the published model are the configuration's own and listed
in its file (no QK-norm, top-k weights renormalized, the ``1 + gain`` norm).
The weights are named as the served model's ``state_dict`` names them, so
that one dictionary feeds both sides.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .common import Precision, attention, f32, gated_mlp, rms_norm

Param = Tuple[str, Tuple[int, ...], str, str]  # name, shape, dtype, init


def params(m: dict) -> List[Param]:
    """Every weight: ``(name, shape, dtype, init kind)``."""
    d, H, KV, ff, E, V = (m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"],
                          m["n_experts"], m["vocab"])
    hd = m.get("head_dim") or d // H
    out: List[Param] = [("embed", (V, d), "bfloat16", "embed"),
                        ("final_norm", (d,), "bfloat16", "gain")]
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1", (d,), "bfloat16", "gain"), (p + "ln2", (d,), "bfloat16", "gain"),
                (p + "attn.w_q", (d, H * hd), "bfloat16", "normal"),
                (p + "attn.w_k", (d, KV * hd), "bfloat16", "normal"),
                (p + "attn.w_v", (d, KV * hd), "bfloat16", "normal"),
                (p + "attn.w_o", (H * hd, d), "bfloat16", "normal"),
                (p + "moe.router", (d, E), "float32", "normal"),
                (p + "moe.w_gate", (E, d, ff), "bfloat16", "normal"),
                (p + "moe.w_up", (E, d, ff), "bfloat16", "normal"),
                (p + "moe.w_down", (E, ff, d), "bfloat16", "normal")]
    out.append(("lm_head", (d, V), "bfloat16", "embed"))
    return out


def moe(prec: Precision, m: dict, w: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """Each token through its top-k experts by router probability, the k
    probabilities renormalized to sum to 1 and the outputs summed with them."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    probs = torch.softmax(x @ w["router"], dim=-1)  # the router stays float32
    top, idx = torch.topk(probs, m["experts_per_token"], dim=-1)
    top = top / top.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            out = gated_mlp(prec, x[rows], w["w_gate"][e], w["w_up"][e], w["w_down"][e])
            y.index_add_(0, rows, out * top[rows, slot, None])
    return y.reshape(shape)


def logits(m: dict, weights: Dict[str, torch.Tensor], tokens: torch.Tensor,
           prec: Optional[Precision] = None) -> torch.Tensor:
    """``[R, T, vocab]`` float32 logits of every position of ``tokens [R, T]``
    (position t predicts token t + 1), one layer's weights in float32 at a
    time; ``prec`` the products' precision (float32 by default)."""
    prec = prec or Precision()
    d, H = m["d_model"], m["n_heads"]
    hd, eps, theta = m.get("head_dim") or d // H, m["norm_eps"], m["rope_theta"]
    x = prec.table(weights["embed"].float())[tokens]
    for i in range(m["n_layers"]):
        w = f32(weights, f"blocks.{i}.")
        attn = {k[5:]: v for k, v in w.items() if k.startswith("attn.")}
        x = x + attention(prec, attn, rms_norm(x, w["ln1"], eps), H, m["n_kv_heads"], hd, theta)
        experts = {k[4:]: v for k, v in w.items() if k.startswith("moe.")}
        x = x + moe(prec, m, experts, rms_norm(x, w["ln2"], eps))
        del w, attn, experts
    h = rms_norm(x, weights["final_norm"].float(), eps)
    return prec.linear(h, weights["lm_head"].float())
