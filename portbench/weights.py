"""Weights drawn from the seed on the device, in the type they are served in.

A flat buffer a dtype (bfloat16 for the projections, float32 for what the
configuration keeps in float32) is filled with standard normal draws on the
device, 2^30 elements a call, and each weight is a view of it, scaled in
place by its kind.
The same seed, device and draw give the same weights, so the benchmark
draws them once for the program and once more, after the window, for the
reference.

Kinds: ``normal`` N(0, 1/fan_in), fan_in the second-to-last dimension;
``embed`` N(0, 0.02^2); ``gain`` N(0, 0.1^2), a norm's gain (the norms
scale by 1 + gain); ``a_log`` log A with A uniform in [1, 16]; ``dt_bias``
softplus^-1 of dt log-uniform in [1e-3, 1e-1]; ``d_skip`` 1 + N(0, 0.1^2):
Mamba2's initialization of its decay, step and skip.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CHUNK = 1 << 30  # elements a draw call fills (kept under 32-bit indexing)


def _shape(t: torch.Tensor, kind: str, shape: Tuple[int, ...]) -> None:
    """Turn standard normal draws ``t`` into the weight kind, in place."""
    if kind == "normal":
        t.mul_(1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1]))
    elif kind == "embed":
        t.mul_(0.02)
    elif kind == "gain":
        t.mul_(0.1)
    elif kind == "d_skip":
        t.mul_(0.1).add_(1.0)
    elif kind in ("a_log", "dt_bias"):
        u = 0.5 * (1.0 + torch.erf(t.float() / math.sqrt(2.0)))  # uniform in (0, 1)
        if kind == "a_log":
            t.copy_(torch.log1p(15.0 * u))
        else:
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            t.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(f"unknown weight kind {kind!r}")


def draw(params: List[Tuple[str, Tuple[int, ...], str, str]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for the ``(name, shape, dtype, kind)`` list, from
    ``seed`` with a generator on ``device``: one draw a dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for dname, dtype in DTYPES.items():
        mine = [p for p in params if p[2] == dname]
        if not mine:
            continue
        flat = torch.empty(sum(math.prod(s) for _, s, _, _ in mine), dtype=dtype, device=device)
        for part in flat.split(CHUNK):
            part.normal_(generator=gen)
        off = 0
        for name, shape, _, kind in mine:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape)
            _shape(out[name], kind, shape)
            off += n
    unknown = {p[2] for p in params} - set(DTYPES)
    if unknown:
        raise ValueError(f"unknown weight dtypes {sorted(unknown)}")
    return {name: out[name] for name, _, _, _ in params}
