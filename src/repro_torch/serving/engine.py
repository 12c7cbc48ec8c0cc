"""Batched serving engine (port of ``repro.serving.engine``).

Requests are taken ``max_batch`` at a time; each batch's prompts are
right-aligned to a common length with zero padding and prefilled token by
token through the decode step, then decoded together, one step per new
token.  Greedy (``argmax``) or temperature sampling from a seeded
``torch.Generator``.

A model bound to a mesh serves the same way on every rank: each rank calls
``generate`` with the same prompts and decodes its rows of each batch, cut
over the batch axes where they divide the batch and all of them where they
do not (the sequence-parallel case: ``distributed.sharding.rows_spec``).  The
new tokens of every row are gathered over those axes once at the end of a
batch, so every rank returns every request's tokens.  A rank samples its own
rows: greedy tokens are the one-rank engine's; sampled ones come from each
rank's own generator.  With an ``eos_token`` the ranks agree, once a step,
whether every row is done.

``stats`` counts the prompt tokens fed (padding included), the decode steps,
the requests, and ``host_syncs``: the engine's reads of the device's results
on the host, one a decode step (its sampled tokens, for the end-token check)
and one a batch (every new token).  With ``repro_torch.tracing`` on, each
batch records the spans that module lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..distributed.collectives import raw_all_gather, raw_all_reduce
from ..distributed.sharding import rows_spec, shard_tensor
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
        self.stats = {"prefill_tokens": 0, "decode_steps": 0, "requests": 0, "host_syncs": 0}

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int,
    ) -> List[List[int]]:
        """Batched generation for a set of prompts; returns prompt + new tokens."""
        out: Dict[int, List[int]] = {}
        pending = list(enumerate(prompts))
        index = 0
        while pending:
            batch = pending[: self.scfg.max_batch]
            pending = pending[len(batch):]
            out.update(self._run_batch(batch, max_new_tokens, index))
            index += 1
        return [out[i] for i in range(len(prompts))]

    def _run_batch(self, batch, max_new_tokens: int, index: int):
        scfg = self.scfg
        device, mesh = self.model.device, self.model.mesh
        B = len(batch)
        plen = max(len(p) for _, p in batch)
        with tracing.span("serve.batch", index=index, rows=B, prompt_len=plen):
            toks = np.zeros((B, plen), np.int64)
            for i, (_, p) in enumerate(batch):
                toks[i, plen - len(p):] = p  # right-aligned so the last token is real
            toks = torch.from_numpy(toks).to(device)
            rows = None if mesh is None else rows_spec(mesh, B)
            if rows is not None:  # this rank's rows
                toks = shard_tensor(toks, (rows,), mesh)
            caches = self.model.init_caches(B, plen + max_new_tokens)
            logits = None
            for t in range(plen):
                with tracing.span("serve.prefill_step", pos=t):
                    logits, caches = self.model.decode_step(caches, toks[:, t], t)
                self.stats["prefill_tokens"] += B
            gen = torch.Generator(device=device).manual_seed(scfg.seed)
            new = []  # the rows' sampled tokens, a step each
            done = np.zeros(toks.shape[0], bool)
            for k in range(max_new_tokens):
                nxt = self._sample(logits, gen)
                new.append(nxt)
                with tracing.span("serve.readback"):
                    done |= nxt.cpu().numpy() == scfg.eos_token
                    self.stats["host_syncs"] += 1
                    if self._all_done(done, rows):
                        break
                with tracing.span("serve.decode_step", pos=plen + k):
                    logits, caches = self.model.decode_step(caches, nxt, plen + k)
                self.stats["decode_steps"] += 1
            new = torch.stack(new, dim=1) if new else toks[:, :0]
            if rows is not None:  # every row's tokens, on every rank
                new = raw_all_gather(new, mesh, rows, dim=0)
            with tracing.span("serve.gather"):
                results = {}
                for (rid, p), seq in zip(batch, new.cpu().tolist()):
                    # a row stops at its end token; the other rows run on
                    stop = seq.index(scfg.eos_token) + 1 if scfg.eos_token in seq else len(seq)
                    results[rid] = list(p) + seq[:stop]
                self.stats["host_syncs"] += 1
            self.stats["requests"] += B
            return results

    def _all_done(self, done: np.ndarray, rows) -> bool:
        """Whether every row of the batch is done; over the ranks that hold
        the other rows where the mesh cuts them (only with an end token)."""
        if rows is None or self.scfg.eos_token < 0:
            return bool(done.all())
        flag = torch.tensor([int(done.all())], dtype=torch.int32)
        return bool(raw_all_reduce(flag, self.model.mesh, rows, op=dist.ReduceOp.MIN)[0])

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        with tracing.span("serve.sample"):
            if self.scfg.temperature <= 0.0:
                return torch.argmax(logits, dim=-1)
            probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0]
