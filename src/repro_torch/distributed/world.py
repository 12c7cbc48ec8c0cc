"""A local process group: run one function on every rank of a spawned world.

The reference gets several devices in one process from
``--xla_force_host_platform_device_count``; ``torch.distributed`` needs one
process per rank.  :func:`run_world` spawns them, joins them in a gloo group
initialised from a file store in a temporary directory, runs
``fn(rank, world_size, *args)`` on each and returns the results by rank.
Everything sent to a rank and back is pickled: pass plain values and return
numpy arrays or host tensors.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable

import torch.distributed as dist

__all__ = ["run_world"]


def _rank_main(fn, rank, world_size, store, timeout_s, args, results):
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, traceback.format_exc(), None))
        raise


def run_world(fn: Callable, world_size: int, *args, timeout: float = 120.0) -> list:
    """``[fn(rank, world_size, *args) for each rank]``, each in its own process.

    ``fn`` must be importable by name (a module-level function).  Raises
    ``RuntimeError`` with the traceback of the first rank that fails, and
    ``TimeoutError`` if the ranks have not all answered within ``timeout``
    seconds; either way every process is ended before it returns.
    """
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, world_size, os.path.join(tmp, "store"),
                                   timeout, args, results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        outs: dict = {}
        answered = False
        try:
            while len(outs) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(outs))} "
                                       f"did not answer within {timeout} s")
                dead = [r for r, p in enumerate(procs)
                        if r not in outs and p.exitcode is not None]
                try:
                    # a rank that exited has flushed its result, if it sent one
                    rank, err, out = results.get(timeout=min(left, 5.0 if dead else 1.0))
                except queue.Empty:
                    if dead:  # it died without a word (a signal, a crash)
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{err}")
                outs[rank] = out
            answered = True
        finally:
            for p in procs:
                if answered:  # every rank has sent its result and is exiting
                    p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            results.close()
    return [outs[r] for r in range(world_size)]
