"""Batched loader with worker threads and prefetch (the JAX package's
data/loader.py).

Map-style datasets: each epoch shuffles the item indices with a numpy
RandomState seeded by seed + epoch, takes this shard's contiguous slice
(every shard the same length), cuts it into batches of `batch_size` and
collates each. The items of a batch come from a pool of `num_workers`
threads (the readers' decode and renders are native calls and numpy, which
release the interpreter lock), and a producer thread keeps up to
`prefetch` collated batches ready while the caller runs its step.
`set_epoch` passes the epoch on to the dataset, whose readers draw each
item from (seed, epoch, index), so the threads do not change the batches.
Iterable datasets (no `__getitem__`: the MSN-Hard stream) are batched in
stream order on the producer thread, with the same bounded queue; their
length in batches is the stream's length over batch size x shards.

One deliberate difference from the JAX loader: an exception raised by the
dataset or the collate in a worker is raised again in the consuming
thread, where the JAX loader ends the epoch early without a word. A
consumer that stops early (a `break`, or closing the iterator) drains the
queue and joins the producer.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np

from gta_tpu_torch.data.synthetic import collate
from gta_tpu_torch.models.context import SceneBatch

_END = object()  # the producer's last message


class _Raised:
    """A producer's exception, carried to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        drop_last: bool = True,
        prefetch: int = 2,
        shard_index: int = 0,
        shard_count: int = 1,
        collate_fn=None,
    ):
        self.collate = collate_fn if collate_fn is not None else collate
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.epoch = 0
        self._iterable = not hasattr(dataset, "__getitem__")

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        if self._iterable:
            return len(self.dataset) // (self.batch_size * self.shard_count)
        n = len(self.dataset) // self.shard_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        # this shard's contiguous slice, every shard cut to the same length
        per = n // self.shard_count
        return idx[self.shard_index * per : (self.shard_index + 1) * per]

    def _stream(self, produce: Callable[[Callable[[], bool], Callable[[SceneBatch], None]], None]
                ) -> Iterator[SceneBatch]:
        """Run `produce(stopped, put)` on a producer thread and yield what it
        puts, at most `prefetch` batches ahead; raise what it raises."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def run():
            try:
                produce(stop.is_set, q.put)
            except Exception as e:  # the consumer raises it
                q.put(_Raised(e))
            finally:
                q.put(_END)

        producer = threading.Thread(target=run, name="Loader-producer", daemon=True)
        producer.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _Raised):
                    raise item.error
                yield item
        finally:
            stop.set()
            # drain, so a producer blocked on a full queue can finish
            while producer.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                producer.join(timeout=0.1)

    def _iter_map(self) -> Iterator[SceneBatch]:
        idx = self._indices().tolist()
        bs = self.batch_size
        nb = len(idx) // bs if self.drop_last else -(-len(idx) // bs)
        with ThreadPoolExecutor(self.num_workers) as pool:

            def produce(stopped, put):
                for b in range(nb):
                    if stopped():
                        return
                    put(self.collate(list(pool.map(self.dataset.__getitem__, idx[b * bs : (b + 1) * bs]))))

            yield from self._stream(produce)

    def _iter_iterable(self) -> Iterator[SceneBatch]:
        def produce(stopped, put):
            items = []
            for item in self.dataset:
                if stopped():
                    return
                items.append(item)
                if len(items) == self.batch_size:
                    put(self.collate(items))
                    items = []
            if items and not self.drop_last:
                put(self.collate(items))

        return self._stream(produce)

    def __iter__(self) -> Iterator[SceneBatch]:
        return self._iter_iterable() if self._iterable else self._iter_map()
