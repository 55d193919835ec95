"""Batched loader, single process (the JAX package's data/loader.py:26-145,
in the calling thread).

Map-style datasets: each epoch shuffles the item indices with a numpy
RandomState seeded by seed + epoch, cuts them into whole batches of
`batch_size` (the last, partial one is dropped) and collates each batch.
`set_epoch` passes the epoch on to the dataset, whose readers draw each
item from (seed, epoch, index). Iterable datasets (no `__getitem__`: the
MSN-Hard stream) are batched in stream order; their length in batches is
the stream's length over the batch size. Worker threads, prefetch and host
sharding are not ported (ROADMAP queue 1, items 6 and 9).
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
        self._iterable = not hasattr(dataset, "__getitem__")

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def _iter_iterable(self) -> Iterator[SceneBatch]:
        items = []
        for item in self.dataset:
            items.append(item)
            if len(items) == self.batch_size:
                yield collate(items)
                items = []

    def __iter__(self) -> Iterator[SceneBatch]:
        if self._iterable:
            yield from self._iter_iterable()
            return
        idx = self._indices()
        for b in range(len(self)):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in sel])
