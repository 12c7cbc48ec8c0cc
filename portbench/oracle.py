"""The comparison that decides ``correct``.

Before each batch of the window a sample of its rows is drawn from the
seed: the row with the batch's longest prompt and one row from each other
stretch of ``B / n`` rows, so that every part of the batch is looked at.
While the batch runs, the logits that the timed path computes for those
rows at the positions that choose their new tokens are kept
(``run.Probe``).  Once the window has closed and the program's state is
freed, the plain float32 reference (``reference/``) gets the same weights
from the seed and the same prompts with the served tokens, and works the
engine's padding out again from the engine's documented semantics: a
batch's prompts are right-aligned to its longest with token 0 in front
and prefilled token by token, so row r of a batch whose longest prompt has
P tokens is ``[0] * (P - len) + prompt + new tokens``, new token k chosen
by the logits at position P - 1 + k.

Numbers read (each cell's limits file, ``limits/<cell>.json``, says which
are compared, and with what limit):

``logit_err``          the program's logits against the reference's at the
                       sampled rows' positions: per position the relative
                       error ||program - reference|| / ||reference|| over
                       the vocabulary, its median over a row's positions,
                       the largest over the rows.
``logit_err_max``      the same relative error, the largest over every
                       sampled row and position: a fault at a few steps
                       shows.  (Where a router picks experts, one expert
                       that bfloat16 flips at a near-tie moves a position
                       as far as a fault does, so such a cell compares the
                       median.)
``served_not_greedy``  served tokens whose logit is not the largest of the
                       program's own logits at their position (limit 0):
                       a token altered between the logits and the answer.
``max_logit_gap``      the widest gap by which a served token's logit lies
                       below the reference's best at its position.
``malformed_outputs``  requests of the window whose output is not their
                       prompt and exactly ``new_tokens`` ids in [0, vocab)
                       (limit 0).
``state_dtype_mismatch`` where the configuration states the dtype of the
                       program's recurrent state (``state_dtype``: cache
                       tensor name to dtype), the cache tensors of those
                       names, as the first decode step of each batch hands
                       them on, held in another dtype (limit 0); a name
                       found nowhere counts once.

A control (``control``) is the reference in the program's place, computed
one precision below what the configuration states (``reference.common``'s
``"fp8"`` below its bfloat16, ``"bf16_state"`` below a float32 state), over
the same sequences: its ``logit_err`` against the float32 reference, and
the gap of the token it puts first.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import weights as weights_mod
from .reference.common import Precision, float32_matmuls


def sample_rows(prompts: Sequence[Sequence[int]], seed: int, index: int, n: int) -> List[int]:
    """Batch ``index``'s rows to compare: the longest prompt's first, then
    one drawn from each other of ``n`` contiguous stretches of the rows."""
    B = len(prompts)
    longest = max(range(B), key=lambda i: len(prompts[i]))
    if n >= B:
        return [longest] + [i for i in range(B) if i != longest]
    rng = np.random.default_rng([seed, 1 << 20, index])
    bounds = [B * j // n for j in range(n + 1)]
    rows = [longest]
    for lo, hi in zip(bounds, bounds[1:]):
        if not lo <= longest < hi:
            rows.append(int(rng.integers(lo, hi)))
    return rows


def malformed(prompts, outs, new_tokens: int, vocab: int) -> int:
    """Requests whose output is not the prompt and ``new_tokens`` valid ids."""
    bad = 0
    for prompt, out in zip(prompts, outs):
        new = out[len(prompt):]
        if (out[:len(prompt)] != list(prompt) or len(new) != new_tokens
                or any(not 0 <= t < vocab for t in new)):
            bad += 1
    return bad


def sequences(batches: List[dict], new_tokens: int):
    """``(tokens [R, T], first [R], served [R, new_tokens])`` of every
    sampled row of every batch, as the engine ran it, right-padded with 0 to
    a common length (later positions never reach earlier ones), with the
    position whose logits choose its first new token, and its new tokens."""
    rows, first, served = [], [], []
    for b in batches:
        plen = max(len(p) for p in b["prompts"])
        for r in b["rows"]:
            prompt, new = b["prompts"][r], b["outs"][r][len(b["prompts"][r]):]
            rows.append([0] * (plen - len(prompt)) + list(prompt) + list(new[:-1]))
            first.append(plen - 1)
            served.append(list(new))
    T = max(len(r) for r in rows)
    tokens = torch.tensor([r + [0] * (T - len(r)) for r in rows], dtype=torch.long)
    return tokens, first, torch.tensor(served, dtype=torch.long)


def reference_logits(reference, m: dict, w: Dict[str, torch.Tensor], tokens: torch.Tensor,
                     first: List[int], n: int, prec: str = "f32") -> torch.Tensor:
    """``[R, n, vocab]``: the reference's logits at the positions choosing
    each row's ``n`` new tokens."""
    with float32_matmuls(), torch.no_grad():
        lg = reference.logits(m, w, tokens.to(w["embed"].device), Precision(prec))
    return torch.stack([lg[r, f:f + n] for r, f in enumerate(first)])


def relative_err(logits: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``[R, n]``: ||logits - ref|| / ||ref|| over the vocabulary (both
    ``[R, n, vocab]``)."""
    return (logits.float() - ref).norm(dim=-1) / ref.norm(dim=-1)


def logit_err(logits: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest over rows of the median over positions of the relative error."""
    return float(relative_err(logits, ref).median(dim=1).values.max())


def logit_err_max(logits: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest relative error over rows and positions."""
    return float(relative_err(logits, ref).max())


def state_dtype_mismatch(stated: Dict[str, str], seen: List[Dict[str, int]]) -> int:
    """Cache tensors held in another dtype than ``stated`` ({name: dtype}),
    counted in ``seen`` (a batch each: {"name:dtype": tensors}); a stated
    name that no batch holds counts once."""
    bad = sum(n for counts in seen for key, n in counts.items()
              if key.split(":")[1] != stated[key.split(":")[0]])
    held = {key.split(":")[0] for counts in seen for key in counts}
    return bad + len(set(stated) - held)


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``[R, n]``: how far each token's reference logit lies below the best."""
    return ref.max(-1).values - ref.gather(-1, tokens.to(ref.device)[..., None])[..., 0]


def readings(cell, seed: int, batches: List[dict], device: torch.device) -> dict:
    """Every number read, ``{name: value}``, the window's batches given as
    ``{"prompts", "outs", "rows", "logits" [rows, new, vocab]}``."""
    m, new = cell.model, cell.traffic["new_tokens"]
    out = {"malformed_outputs": sum(malformed(b["prompts"], b["outs"], new, m["vocab"])
                                    for b in batches)}
    if out["malformed_outputs"]:
        return {**out, "logit_err": float("inf"), "served_not_greedy": float("inf"),
                "max_logit_gap": float("inf"), "state_dtype_mismatch": float("inf"),
                "logit_err_max": float("inf")}
    tokens, first, served = sequences(batches, new)
    program = torch.cat([b["logits"] for b in batches]).to(device)
    picked = program.gather(-1, served.to(device)[..., None])[..., 0]
    out["served_not_greedy"] = int((picked < program.max(-1).values).sum())
    w = weights_mod.draw(cell.reference.params(m), seed, device)
    ref = reference_logits(cell.reference, m, w, tokens, first, new)
    out["logit_err"] = logit_err(program, ref)
    out["logit_err_max"] = logit_err_max(program, ref)
    out["max_logit_gap"] = float(gaps(ref, served).max())
    out["served_tokens"] = int(served.numel())
    if "state_dtype" in cell.config:
        out["state_dtype_mismatch"] = state_dtype_mismatch(
            cell.config["state_dtype"], [b.get("state_dtypes", {}) for b in batches])
    return out


def checks(cell, read: dict) -> dict:
    """The numbers the cell's limits file gives a limit: ``{name: {"value", "limit"}}``."""
    return {name: {"value": read[name], "limit": spec["limit"]}
            for name, spec in cell.limits.items() if isinstance(spec, dict) and "limit" in spec}


def is_correct(compared: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())


def controls(cell) -> List[str]:
    """The cell's controls: float8 below the configuration's bfloat16, and a
    bfloat16 state where the configuration states a float32 one."""
    out = ["fp8"]
    if "float32" in cell.config.get("state_dtype", {}).values():
        out.append("bf16_state")
    return out


def control(cell, seed: int, batches: List[dict], device: torch.device) -> dict:
    """Each control's readings over the same sequences as the program's:
    ``{control: {"logit_err", "max_logit_gap"}}``."""
    m, new = cell.model, cell.traffic["new_tokens"]
    tokens, first, _ = sequences(batches, new)
    w = weights_mod.draw(cell.reference.params(m), seed, device)
    ref = reference_logits(cell.reference, m, w, tokens, first, new)
    out = {}
    for prec in controls(cell):
        low = reference_logits(cell.reference, m, w, tokens, first, new, prec)
        out[prec] = {"logit_err": logit_err(low, ref), "logit_err_max": logit_err_max(low, ref),
                     "max_logit_gap": float(gaps(ref, low.argmax(-1)).max())}
    return out
