"""Synthetic-but-learnable token pipeline (a copy of ``repro/data/pipeline.py``).

Deterministic numpy batches keyed by ``(step, host)``, bit for bit the
reference's: each host computes only its slice (``host_batch = global_batch
/ n_hosts``).  Sequences are drawn from a sparse Markov chain, so a model can
lower its loss, with document boundaries packed as separator tokens.
``prefetch`` overlaps batch synthesis with the step on a background thread.

The chain's transition table is ``[vocab, vocab]`` float64 (with its cumulative
sums, two such arrays): at a model's full vocabulary it does not fit (262,144
for gemma3-1b is 550 GB an array), so a full-width run draws its tokens from a
smaller ``vocab``, a subset of the model's ids.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLMDataset", "prefetch"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int = 1024
    seq_len: int = 128
    global_batch: int = 8
    n_hosts: int = 1
    seed: int = 0
    markov_order: int = 1
    separator_token: int = 0
    mean_doc_len: int = 64


class SyntheticLMDataset:
    """Deterministic Markov-chain LM data, shardable by host."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # sparse-ish transition structure => learnable bigram statistics
        logits = rng.normal(0.0, 2.0, size=(cfg.vocab, cfg.vocab))
        keep = rng.random((cfg.vocab, cfg.vocab)) < (16.0 / cfg.vocab)
        logits = np.where(keep, logits, -1e9)
        logits[:, 1 % cfg.vocab] = 0.0  # guarantee an escape transition
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        self._P = p / p.sum(axis=1, keepdims=True)
        self._cumP = np.cumsum(self._P, axis=1)

    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def batch(self, step: int, host: int = 0) -> Dict[str, np.ndarray]:
        """tokens/labels [host_batch, seq_len] int32 for (step, host)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) * 4099 + host)
        B, S = self.host_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int64)
        state = rng.integers(0, cfg.vocab, size=B)
        doc_left = rng.geometric(1.0 / cfg.mean_doc_len, size=B)
        for t in range(S + 1):
            u = rng.random(B)
            state = (self._cumP[state] > u[:, None]).argmax(axis=1)
            end = doc_left <= 0
            if end.any():
                state = np.where(end, cfg.separator_token, state)
                doc_left = np.where(
                    end, rng.geometric(1.0 / cfg.mean_doc_len, size=B), doc_left)
            toks[:, t] = state
            doc_left -= 1
        return {"tokens": toks[:, :S].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch with a bounded queue, in order."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
