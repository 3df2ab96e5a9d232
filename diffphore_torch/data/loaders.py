"""Bucketed batch loader: complexes are grouped by their (A, P, T) pad
signature, shuffled within buckets, and emitted as fixed-size batches; a
short final batch is padded by repeating samples, with ``valid`` false on
the repeated rows."""

from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from .graphs import ComplexBatch, concat_batches


class BucketLoader:
    def __init__(self, dataset, batch_size: int = 8, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        # bucket by pad signature (cheap: read shapes from the npz header)
        self.buckets: Dict[Tuple[int, int, int], List[int]] = collections.defaultdict(list)
        for i in range(len(dataset)):
            with np.load(dataset.files[i]) as z:
                sig = (z["lig_pos"].shape[1], z["phore_pos"].shape[1], z["tor_edges"].shape[1])
            self.buckets[sig].append(i)

    def __len__(self) -> int:
        n = 0
        for idxs in self.buckets.values():
            full, rem = divmod(len(idxs), self.batch_size)
            n += full + (0 if (self.drop_last or rem == 0) else 1)
        return n

    def __iter__(self) -> Iterator[ComplexBatch]:
        plans: List[Tuple[List[int], int]] = []
        for idxs in self.buckets.values():
            order = list(idxs)
            if self.shuffle:
                self.rng.shuffle(order)
            for k in range(0, len(order), self.batch_size):
                chunk = order[k:k + self.batch_size]
                n_real = len(chunk)
                if n_real < self.batch_size:
                    if self.drop_last:
                        continue
                    chunk = chunk + [chunk[i % n_real] for i in range(self.batch_size - n_real)]
                plans.append((chunk, n_real))
        if self.shuffle:
            self.rng.shuffle(plans)
        for chunk, n_real in plans:
            batch = concat_batches([self.dataset[i] for i in chunk])
            if n_real < len(chunk):
                valid = torch.zeros(len(chunk), dtype=torch.bool)
                valid[:n_real] = True
                batch = batch.replace(valid=valid)
            yield batch
