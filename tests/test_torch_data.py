"""The port's data pipeline against ``repro.data``: the same batches bit for
bit for every ``(step, host)``, and ``prefetch`` keeps order."""

import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JSyntheticLMDataset
from repro_torch.data import DataConfig, SyntheticLMDataset, prefetch

CONFIGS = [dict(vocab=256, seq_len=32, global_batch=8, n_hosts=2),
           dict(vocab=4096, seq_len=64, global_batch=4, n_hosts=1, seed=3, mean_doc_len=16),
           dict(vocab=97, seq_len=16, global_batch=6, n_hosts=3, separator_token=5)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_batches_identical_to_reference(kw):
    mine, ref = SyntheticLMDataset(DataConfig(**kw)), JSyntheticLMDataset(JDataConfig(**kw))
    assert mine.host_batch == ref.host_batch == kw["global_batch"] // kw["n_hosts"]
    for step in (0, 1, 7, 1000):
        for host in range(kw["n_hosts"]):
            a, b = mine.batch(step, host), ref.batch(step, host)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
            assert a["tokens"].shape == (mine.host_batch, kw["seq_len"])
            np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    it = iter(mine)
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"], ref.batch(step)["tokens"])


def test_hosts_get_different_slices_and_uneven_split_raises():
    ds = SyntheticLMDataset(DataConfig(vocab=128, seq_len=16, global_batch=4, n_hosts=2))
    assert not np.array_equal(ds.batch(0, 0)["tokens"], ds.batch(0, 1)["tokens"])
    with pytest.raises(ValueError, match="divide"):
        SyntheticLMDataset(DataConfig(global_batch=5, n_hosts=2))


def test_prefetch_preserves_order():
    assert list(prefetch(iter(range(50)), depth=3)) == list(range(50))
    ds = SyntheticLMDataset(DataConfig(vocab=64, seq_len=8, global_batch=2))
    got = prefetch(iter(ds), depth=2)
    for step in range(4):
        np.testing.assert_array_equal(next(got)["tokens"], ds.batch(step)["tokens"])
