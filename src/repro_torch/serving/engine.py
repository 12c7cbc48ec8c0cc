"""Batched serving engine (port of ``repro.serving.engine``).

Requests are taken ``max_batch`` at a time; each batch's prompts are
right-aligned to a common length with zero padding and prefilled token by
token through the decode step, then decoded together, one step per new
token.  Greedy (``argmax``) or temperature sampling from a seeded
``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..models import Model

__all__ = ["ServeConfig", "ServeEngine"]


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    temperature: float = 0.0  # 0 => greedy
    eos_token: int = -1       # -1 => never stop early
    seed: int = 0


class ServeEngine:
    """Serves a :class:`Model` on the model's device; the parameters live in it."""

    def __init__(self, model: Model, scfg: ServeConfig):
        self.model = model
        self.scfg = scfg
        self.stats = {"prefill_tokens": 0, "decode_steps": 0, "requests": 0}

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int,
    ) -> List[List[int]]:
        """Batched generation for a set of prompts; returns prompt + new tokens."""
        out: Dict[int, List[int]] = {}
        pending = list(enumerate(prompts))
        while pending:
            batch = pending[: self.scfg.max_batch]
            pending = pending[len(batch):]
            out.update(self._run_batch(batch, max_new_tokens))
        return [out[i] for i in range(len(prompts))]

    def _run_batch(self, batch, max_new_tokens: int):
        scfg = self.scfg
        device = self.model.device
        B = len(batch)
        plen = max(len(p) for _, p in batch)
        toks = np.zeros((B, plen), np.int64)
        for i, (_, p) in enumerate(batch):
            toks[i, plen - len(p):] = p  # right-aligned so the last token is real
        toks = torch.from_numpy(toks).to(device)
        caches = self.model.init_caches(B, plen + max_new_tokens)
        logits = None
        for t in range(plen):
            logits, caches = self.model.decode_step(caches, toks[:, t], t)
            self.stats["prefill_tokens"] += B
        gen = torch.Generator(device=device).manual_seed(scfg.seed)
        results = {rid: list(p) for rid, p in batch}
        done = np.zeros(B, bool)
        for k in range(max_new_tokens):
            nxt = self._sample(logits, gen)
            nxt_host = nxt.cpu().numpy()
            for i, (rid, _) in enumerate(batch):
                if not done[i]:
                    tok = int(nxt_host[i])
                    results[rid].append(tok)
                    if tok == scfg.eos_token:
                        done[i] = True
            if done.all():
                break
            logits, caches = self.model.decode_step(caches, nxt, plen + k)
            self.stats["decode_steps"] += 1
        self.stats["requests"] += B
        return results

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
