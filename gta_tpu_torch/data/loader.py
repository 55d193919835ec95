"""Batched loader, single process (the map-style part of the JAX package's
data/loader.py:26-75).

Each epoch shuffles the item indices with a numpy RandomState seeded by
seed + epoch, cuts them into whole batches of `batch_size` (the last,
partial one is dropped) and collates each batch in the calling thread.
Worker threads, prefetch, iterable datasets and host sharding are not
ported (ROADMAP queue 1, items 6 and 9).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from gta_tpu_torch.data.synthetic import collate
from gta_tpu_torch.models.context import SceneBatch


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[SceneBatch]:
        idx = self._indices()
        for b in range(len(self)):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in sel])
