"""Checkpoint store: a JSON index and zlib-compressed raw tensor bytes.

Port of ``repro/checkpoint/store.py`` with another container: the reference
writes a msgpack index and zstd (zlib where zstandard is missing); the port
uses the standard library alone, an ``index.json`` with the same fields and
a zlib payload.  Layout per step::

    <dir>/step_0000042/
        index.json     # {"entries": [{key, shape, dtype, offset, nbytes, crc32}], "total"}
        data.bin.zlib  # the tensors' raw bytes, concatenated, zlib-compressed
        COMMIT         # written last; its absence marks a torn checkpoint

A tree is a nested dict of tensors; a key is the path of
names joined by ``/`` (``state/mu/embed``).  bf16 tensors are stored as their
raw 2-byte words.  Each tensor's bytes carry a crc32, checked on load.  The
COMMIT marker makes restores crash-safe: a save interrupted by a failure is
invisible to :func:`restore_latest`.  :class:`CheckpointManager` adds
background saves, retention and restart bookkeeping.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_tree", "load_tree", "restore_latest", "CheckpointManager"]

INDEX, DATA, COMMIT = "index.json", "data.bin.zlib", "COMMIT"


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key, leaf)`` of a nested dict, depth first in insertion order."""
    out = []
    for name, leaf in tree.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, dict):
            out.extend(_flatten(leaf, key + "/"))
        else:
            out.append((key, leaf))
    return out


def _raw(leaf: torch.Tensor) -> Tuple[bytes, str, List[int]]:
    """The bytes, dtype name and shape of a tensor (copied to the host)."""
    t = leaf.detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().tobytes(), name, list(t.shape)
    return t.numpy().tobytes(), name, list(t.shape)


def _from_raw(raw: bytes, dtype: str, shape: List[int]) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy())


def save_tree(tree, path: str) -> None:
    """Write ``tree`` to the step directory ``path``, COMMIT last."""
    os.makedirs(path, exist_ok=True)
    entries, blobs, off = [], [], 0
    for key, leaf in _flatten(tree):
        raw, dtype, shape = _raw(leaf)
        entries.append({"key": key, "shape": shape, "dtype": dtype, "offset": off,
                        "nbytes": len(raw), "crc32": zlib.crc32(raw)})
        blobs.append(raw)
        off += len(raw)
    with open(os.path.join(path, DATA), "wb") as f:
        f.write(zlib.compress(b"".join(blobs), 6))
    with open(os.path.join(path, INDEX), "w") as f:
        json.dump({"entries": entries, "total": off}, f)
    # commit marker last: restores ignore torn checkpoints
    with open(os.path.join(path, COMMIT), "w") as f:
        f.write("ok")


def load_tree(template, path: str, device: Optional[torch.device] = None):
    """Restore into the structure of ``template`` (a nested dict of tensors,
    which may lie on the ``meta`` device): each leaf gets the template leaf's
    dtype, and ``device`` or else the leaf's device.  Raises on a missing
    tensor, a shape that differs from the template's, or a checksum mismatch."""
    if not os.path.exists(os.path.join(path, COMMIT)):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, INDEX)) as f:
        index = json.load(f)
    with open(os.path.join(path, DATA), "rb") as f:
        payload = zlib.decompress(f.read())
    by_key = {e["key"]: e for e in index["entries"]}

    def restore(sub, prefix):
        out = {}
        for name, leaf in sub.items():
            key = f"{prefix}{name}"
            if isinstance(leaf, dict):
                out[name] = restore(leaf, key + "/")
                continue
            e = by_key.get(key)
            if e is None:
                raise KeyError(f"checkpoint missing tensor {key}")
            raw = payload[e["offset"]:e["offset"] + e["nbytes"]]
            if zlib.crc32(raw) != e["crc32"]:
                raise IOError(f"checksum mismatch for {key}")
            if list(leaf.shape) != e["shape"]:
                raise ValueError(f"{key}: checkpoint shape {e['shape']} != {list(leaf.shape)}")
            out[name] = _from_raw(raw, e["dtype"], e["shape"]).to(
                device=leaf.device if device is None else device, dtype=leaf.dtype)
        return out

    return restore(template, "")


def _step_dirs(root: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_"):
            full = os.path.join(root, name)
            if os.path.exists(os.path.join(full, COMMIT)):
                try:
                    out.append((int(name.split("_")[1]), full))
                except ValueError:
                    continue
    return sorted(out)


def restore_latest(template, root: str, device: Optional[torch.device] = None):
    """``(step, tree)`` from the newest committed checkpoint, or ``(None, None)``."""
    dirs = _step_dirs(root)
    if not dirs:
        return None, None
    step, path = dirs[-1]
    return step, load_tree(template, path, device)


class CheckpointManager:
    """Background, retained, crash-safe checkpoints."""

    def __init__(self, root: str, *, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    def path_for(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:07d}")

    def save(self, step: int, tree) -> None:
        """Copy ``tree`` to host memory now, then write it (on a background
        thread with ``async_save``), so training may update its tensors at once."""
        host_tree = _snapshot(tree)

        def do_save():
            try:
                save_tree(host_tree, self.path_for(step))
                self._gc()
            except BaseException as e:  # re-raised by wait(), on the caller's thread
                self._error = e

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=do_save, daemon=True)
            self._thread.start()
        else:
            do_save()
            self.wait()

    def wait(self) -> None:
        """Join the background save, if one runs; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    def restore_latest(self, template, device: Optional[torch.device] = None):
        self.wait()
        return restore_latest(template, self.root, device)

    def steps(self) -> List[int]:
        return [s for s, _ in _step_dirs(self.root)]

    def _gc(self) -> None:
        dirs = _step_dirs(self.root)
        for _, path in dirs[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(path, ignore_errors=True)


def _snapshot(tree) -> Dict[str, Any]:
    """A host copy of every leaf (a copy even of a CPU tensor)."""
    return {name: _snapshot(leaf) if isinstance(leaf, dict) else
            leaf.detach().to("cpu", copy=True) for name, leaf in tree.items()}
