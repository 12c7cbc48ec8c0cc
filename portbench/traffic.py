"""The one traffic generator: a mix's parameters and the seed give the batches.

A mix is a data file (``traffic/<mix>.json``).  Its keys:

``loop``        ``"closed_batches"``: offline batches, back to back; a batch
                is handed to the engine whole and the next starts when it
                has returned.
``batch``       requests a batch (the engine's ``max_batch``).
``prompt_len``  ``[lo, hi]``: each prompt's length, uniform, both ends in.
``new_tokens``  tokens generated for every request (no end token).
``sampling``    ``"greedy"``.

Prompt ids are uniform in [1, vocab).  Batch ``i`` of seed ``s`` is drawn
from its own stream, ``numpy.random.default_rng([s, i])``, so a run can draw
as many batches as its window holds and the same seed always gives the same
batches.
"""

from __future__ import annotations

from typing import List

import numpy as np

LOOPS = ("closed_batches",)
SAMPLING = ("greedy",)


def validate(mix: dict) -> dict:
    """The mix, checked: a malformed file fails before any run."""
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"traffic loop {mix.get('loop')!r} is not one of {LOOPS}")
    if mix.get("sampling") not in SAMPLING:
        raise ValueError(f"traffic sampling {mix.get('sampling')!r} is not one of {SAMPLING}")
    lo, hi = mix["prompt_len"]
    if not (1 <= lo <= hi and mix["batch"] >= 1 and mix["new_tokens"] >= 2):
        raise ValueError(f"traffic sizes out of range: {mix}")
    return mix


def batch(mix: dict, vocab: int, seed: int, index: int) -> List[List[int]]:
    """Batch ``index``'s prompts under ``seed``."""
    rng = np.random.default_rng([seed, index])
    lo, hi = mix["prompt_len"]
    lens = rng.integers(lo, hi + 1, size=mix["batch"])
    ids = rng.integers(1, vocab, size=(mix["batch"], hi))
    return [row[:n].tolist() for row, n in zip(ids, lens)]
