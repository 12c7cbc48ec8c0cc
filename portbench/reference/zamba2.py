"""Zamba2 (arXiv:2411.15242) as the configuration file states it, in plain
float32: a backbone of pre-norm Mamba2 layers and one shared pre-norm block
(causal attention with RoPE, then a SiLU-gated MLP) applied after every
``attn_block_every`` of them, a final norm and an untied head.

The Mamba2 layer, one group (B and C shared by all heads):
    [z, xBC, dt] = h W_in
    xBC_t        = silu(sum_i conv[i] * xBC_{t-K+1+i})      (causal, depthwise)
    dt_t         = softplus(dt_t + dt_bias),  A = exp(a_log)
    S_t          = exp(-A dt_t) S_{t-1} + dt_t x_t B_t^T     (per head)
    y_t          = S_t C_t + D x_t
    out          = (y * silu(z + norm_z)) W_out
computed step by step over time, in heads of 64 (one head where d_inner is
narrower).  Departures from the published model are the configuration's
own, listed in its file.  The weights are named as the
served model's ``state_dict`` names them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import Precision, attention, f32, gated_mlp, rms_norm

Param = Tuple[str, Tuple[int, ...], str, str]  # name, shape, dtype, init


def dims(m: dict) -> Tuple[int, int, int]:
    """``(d_inner, heads, columns of W_in)``: Mamba2's heads of 64 (one head
    where d_inner is narrower)."""
    d_inner = m["ssm_expand"] * m["d_model"]
    heads = max(1, d_inner // 64)
    return d_inner, heads, 2 * d_inner + 2 * m["ssm_state"] + heads


def plan(m: dict) -> List[str]:
    """The applied blocks in order: ``"mamba"`` or ``"shared"``; the shared
    block follows each full group of ``attn_block_every`` Mamba2 layers, and a
    last short group too."""
    L, every, out, done = m["n_layers"], m["attn_block_every"], [], 0
    while done < L:
        n = min(every, L - done)
        out += ["mamba"] * n
        done += n
        if done < L or n == every:
            out.append("shared")
    return out


def params(m: dict) -> List[Param]:
    """Every weight: ``(name, shape, dtype, init kind)``."""
    d, H, KV, ff, V = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"], m["vocab"]
    hd = m.get("head_dim") or d // H
    d_inner, heads, cols = dims(m)
    ds, K = m["ssm_state"], m["ssm_conv"]
    out: List[Param] = [("embed", (V, d), "bfloat16", "embed"),
                        ("final_norm", (d,), "bfloat16", "gain")]
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1", (d,), "bfloat16", "gain"),
                (p + "mamba.w_in", (d, cols), "bfloat16", "normal"),
                (p + "mamba.conv_w", (K, d_inner + 2 * ds), "bfloat16", "normal"),
                (p + "mamba.a_log", (heads,), "float32", "a_log"),
                (p + "mamba.d_skip", (heads,), "float32", "d_skip"),
                (p + "mamba.dt_bias", (heads,), "float32", "dt_bias"),
                (p + "mamba.w_out", (d_inner, d), "bfloat16", "normal"),
                (p + "mamba.norm_z", (d_inner,), "bfloat16", "gain")]
    if "shared" in plan(m):
        out += [("shared.ln1", (d,), "bfloat16", "gain"), ("shared.ln2", (d,), "bfloat16", "gain"),
                ("shared.attn.w_q", (d, H * hd), "bfloat16", "normal"),
                ("shared.attn.w_k", (d, KV * hd), "bfloat16", "normal"),
                ("shared.attn.w_v", (d, KV * hd), "bfloat16", "normal"),
                ("shared.attn.w_o", (H * hd, d), "bfloat16", "normal"),
                ("shared.mlp.w_gate", (d, ff), "bfloat16", "normal"),
                ("shared.mlp.w_up", (d, ff), "bfloat16", "normal"),
                ("shared.mlp.w_down", (ff, d), "bfloat16", "normal")]
    out.append(("lm_head", (d, V), "bfloat16", "embed"))
    return out


def mamba(prec: Precision, m: dict, w: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """One Mamba2 mixer over ``h [R, T, d]`` from a zero state."""
    R, T, _ = h.shape
    d_inner, heads, _ = dims(m)
    ds, K = m["ssm_state"], m["ssm_conv"]
    z, xbc, dt = torch.split(prec.linear(h, w["w_in"]), [d_inner, d_inner + 2 * ds, heads], -1)
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    xbc = F.silu(sum(padded[:, i:i + T] * w["conv_w"][i] for i in range(K)))
    x, b, c = torch.split(xbc, [d_inner, ds, ds], -1)
    x = x.reshape(R, T, heads, d_inner // heads)
    dt = F.softplus(dt + w["dt_bias"])  # [R, T, heads]
    decay = torch.exp(-torch.exp(w["a_log"]) * dt)
    state = torch.zeros(R, heads, d_inner // heads, ds, device=h.device)
    ys = []
    for t in range(T):
        state = prec.state(decay[:, t, :, None, None] * state
                           + (dt[:, t, :, None] * x[:, t])[..., None] * b[:, t, None, None, :])
        ys.append(torch.einsum("rhps,rs->rhp", state, c[:, t]) + w["d_skip"][:, None] * x[:, t])
    y = torch.stack(ys, dim=1).reshape(R, T, d_inner)
    return prec.linear(y * F.silu(z + w["norm_z"]), w["w_out"])


def logits(m: dict, weights: Dict[str, torch.Tensor], tokens: torch.Tensor,
           prec: Optional[Precision] = None) -> torch.Tensor:
    """``[R, T, vocab]`` float32 logits of every position of ``tokens [R, T]``
    (position t predicts token t + 1), one layer's weights in float32 at a
    time; ``prec`` the products' precision (float32 by default)."""
    prec = prec or Precision()
    d, H = m["d_model"], m["n_heads"]
    hd, eps, theta = m.get("head_dim") or d // H, m["norm_eps"], m["rope_theta"]
    x = prec.table(weights["embed"].float())[tokens]
    shared = f32(weights, "shared.") if "shared.ln1" in weights else None
    layer = 0
    for kind in plan(m):
        if kind == "mamba":
            w = f32(weights, f"blocks.{layer}.")
            mixer = {k[6:]: v for k, v in w.items() if k.startswith("mamba.")}
            x = x + mamba(prec, m, mixer, rms_norm(x, w["ln1"], eps))
            layer += 1
            continue
        attn = {k[5:]: v for k, v in shared.items() if k.startswith("attn.")}
        x = x + attention(prec, attn, rms_norm(x, shared["ln1"], eps), H, m["n_kv_heads"], hd,
                          theta)
        x = x + gated_mlp(prec, rms_norm(x, shared["ln2"], eps), shared["mlp.w_gate"],
                          shared["mlp.w_up"], shared["mlp.w_down"])
    h = rms_norm(x, weights["final_norm"].float(), eps)
    return prec.linear(h, weights["lm_head"].float())
