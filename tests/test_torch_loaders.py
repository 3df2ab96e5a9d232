"""The port's cached dataset and bucket loader against the JAX package's
``BucketLoader`` over the same cache files: same buckets, same batch plans
from the same seed, repeat padding and ``valid``."""

import os
import shutil

import numpy as np
import pytest
import torch

from diffphore_torch.data import graphs as tgraphs
from diffphore_torch.data.dataset import (CachedDataset, Subset, cache_directories,
                                          warmup_subset)
from diffphore_torch.data.loaders import BucketLoader as TLoader
from diffphore_tpu.data.dataset import load_complex
from diffphore_tpu.data.loaders import BucketLoader as JLoader

from torch_port_helpers import CACHE


class _JaxDataset:
    """The JAX loader's view of a list of cache files."""

    def __init__(self, files):
        self.files = list(files)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i):
        return load_complex(self.files[i])


@pytest.fixture(scope="module")
def dataset():
    return CachedDataset([CACHE])


def test_cached_dataset_reads_every_file(dataset):
    assert len(dataset) == 30
    assert dataset.files == sorted(dataset.files)
    one = dataset[3]
    assert one.batch_size == 1 and one.names and one.lig_pos.dtype == torch.float32
    assert dataset[3] is one                                  # RAM cache
    assert CachedDataset([CACHE], ram_cache=False)[3] is not one
    assert len(CachedDataset([CACHE], limit=7)) == 7
    with pytest.raises(FileNotFoundError):
        CachedDataset([os.path.join(CACHE, "missing")])


@pytest.mark.parametrize("batch_size,shuffle", [(4, False), (4, True), (7, True)])
def test_bucket_loader_matches_jax_loader(dataset, batch_size, shuffle):
    """Same buckets, the same number of batches, and batch by batch the same
    complexes in the same order with the same ``valid`` rows and arrays."""
    tl = TLoader(dataset, batch_size, shuffle=shuffle, seed=3)
    jl = JLoader(_JaxDataset(dataset.files), batch_size, shuffle=shuffle, seed=3)
    assert dict(tl.buckets) == dict(jl.buckets)
    assert len(tl) == len(jl)
    tbs, jbs = list(tl), list(jl)
    assert len(tbs) == len(jbs) == len(tl)
    padded = 0
    for tb, jb in zip(tbs, jbs):
        assert tuple(tb.names) == tuple(jb.names)
        assert tb.batch_size == batch_size
        np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
        np.testing.assert_array_equal(tb.lig_pos.numpy(), np.asarray(jb.lig_pos))
        np.testing.assert_array_equal(tb.tor_mask.numpy(), np.asarray(jb.tor_mask))
        padded += int((~tb.valid).sum())
        n_real = int(tb.valid.sum())
        if n_real < batch_size:      # repeat padding cycles through the real rows
            assert list(tb.names[n_real:]) == [tb.names[i % n_real]
                                               for i in range(batch_size - n_real)]
    assert padded > 0
    assert sum(int(b.valid.sum()) for b in tbs) == len(dataset)


def test_bucket_loader_drop_last_and_reshuffle(dataset):
    tl = TLoader(dataset, 4, shuffle=True, seed=0, drop_last=True)
    first = [b.names for b in tl]
    second = [b.names for b in tl]
    assert len(first) == len(tl) and all(len(n) == 4 for n in first)
    assert all(bool(b.valid.all()) for b in tl)
    assert first != second                     # a new epoch, a new order
    again = [b.names for b in TLoader(dataset, 4, shuffle=True, seed=0, drop_last=True)]
    assert again == first


def test_subsets_and_cache_directories(dataset, tmp_path):
    sub = warmup_subset(dataset, 5, 0.0, seed=1)
    assert isinstance(sub, Subset) and len(sub) == 5
    assert sub[2].names == dataset[sub.indices[2]].names
    assert warmup_subset(dataset, 0, 0.1, seed=1).indices == warmup_subset(
        dataset, 3, 0.0, seed=1).indices
    assert warmup_subset(dataset, 100, 0.0) is dataset
    assert len(list(TLoader(sub, 2, shuffle=False))) >= 3

    for name in ("train_aaa", "train_bbb", "val_aaa", "other"):
        (tmp_path / name).mkdir()
    shutil.copy(dataset.files[0], tmp_path / "train_aaa")
    found = cache_directories(str(tmp_path), "train")
    assert [os.path.basename(d) for d in found] == ["train_aaa", "train_bbb"]
    assert [os.path.basename(d) for d in cache_directories(str(tmp_path), "val")] == ["val_aaa"]
    assert cache_directories(str(tmp_path / "other"), "train") == []
    assert tgraphs.load_cached(dataset.files[0]).names == dataset[0].names
