"""The port's checkpoint store: roundtrip bit for bit (bf16 as raw 2-byte
words), crash safety (a torn save is invisible), checksums, retention and
background saves; and the index keeps the reference's fields."""

import json
import os
import threading

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, load_tree, restore_latest, save_tree
from repro_torch.checkpoint.store import DATA, INDEX


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"embed": torch.randn(8, 4, generator=g).to(torch.bfloat16),
                       "blocks.0.ln1": torch.randn(4, generator=g).to(torch.bfloat16)},
            "state": {"step": torch.tensor(7, dtype=torch.int32),
                      "mu": {"embed": torch.randn(8, 4, generator=g)}},
            "host": torch.arange(6, dtype=torch.int64).reshape(2, 3)}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def test_roundtrip_bit_for_bit_and_index_fields(tmp_path):
    tree = _tree()
    save_tree(tree, str(tmp_path / "s"))
    back = load_tree(tree, str(tmp_path / "s"))
    assert _equal(back, tree)
    index = json.loads((tmp_path / "s" / INDEX).read_text())
    keys = [e["key"] for e in index["entries"]]
    assert keys == ["params/embed", "params/blocks.0.ln1", "state/step", "state/mu/embed", "host"]
    e = index["entries"][0]
    assert set(e) == {"key", "shape", "dtype", "offset", "nbytes", "crc32"}
    assert e["dtype"] == "bfloat16" and e["nbytes"] == 8 * 4 * 2 and e["shape"] == [8, 4]
    assert index["total"] == sum(x["nbytes"] for x in index["entries"])
    assert (tmp_path / "s" / DATA).read_bytes()[:1] == b"\x78"  # a zlib stream


def test_load_onto_meta_template_and_device(tmp_path):
    tree = _tree(1)
    save_tree(tree, str(tmp_path / "s"))
    meta = {"params": {k: torch.empty_like(v, device="meta") for k, v in tree["params"].items()}}
    back = load_tree(meta, str(tmp_path / "s"), device=torch.device("cpu"))
    assert _equal(back["params"], tree["params"])


def test_torn_save_is_invisible_and_checksums_hold(tmp_path):
    root = str(tmp_path)
    save_tree(_tree(0), os.path.join(root, "step_0000001"))
    save_tree(_tree(1), os.path.join(root, "step_0000002"))
    os.remove(os.path.join(root, "step_0000002", "COMMIT"))  # torn: no commit marker
    step, tree = restore_latest(_tree(), root)
    assert step == 1 and _equal(tree["params"], _tree(0)["params"])
    with pytest.raises(FileNotFoundError):
        load_tree(_tree(), os.path.join(root, "step_0000002"))
    # a corrupted index entry fails its crc32 check
    path = os.path.join(root, "step_0000001")
    index = json.loads(open(os.path.join(path, INDEX)).read())
    index["entries"][0]["crc32"] ^= 1
    with open(os.path.join(path, INDEX), "w") as f:
        json.dump(index, f)
    with pytest.raises(IOError, match="checksum"):
        load_tree(_tree(), path)
    with pytest.raises(KeyError, match="missing"):
        load_tree({"nope": torch.zeros(1)}, os.path.join(root, "step_0000001"))
    assert restore_latest(_tree(), str(tmp_path / "empty")) == (None, None)


def test_shape_mismatch_raises(tmp_path):
    save_tree({"w": torch.zeros(4)}, str(tmp_path / "s"))
    with pytest.raises(ValueError, match="shape"):
        load_tree({"w": torch.zeros(5)}, str(tmp_path / "s"))


@pytest.mark.parametrize("async_save", [True, False])
def test_manager_retention_and_snapshot(tmp_path, async_save):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    w = torch.zeros(3)
    for step in (1, 2, 3, 4):
        w.fill_(step)
        mgr.save(step, {"w": w})
        w.fill_(-1.0)  # training moves on at once: the save holds its own copy
    mgr.wait()
    assert mgr.steps() == [3, 4]
    step, tree = mgr.restore_latest({"w": torch.zeros(3)})
    assert step == 4 and torch.equal(tree["w"], torch.full((3,), 4.0))


def test_async_save_runs_in_the_background_and_reports_errors(tmp_path, monkeypatch):
    from repro_torch.checkpoint import store

    release = threading.Event()
    real = store.save_tree

    def slow(tree, path):
        assert release.wait(10)
        real(tree, path)

    monkeypatch.setattr(store, "save_tree", slow)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"w": torch.ones(2)})
    assert mgr.steps() == []  # not committed yet: the writer waits
    release.set()
    mgr.wait()
    assert mgr.steps() == [1]

    def broken(tree, path):
        raise OSError("disk full")

    monkeypatch.setattr(store, "save_tree", broken)
    mgr.save(2, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.steps() == [1]
