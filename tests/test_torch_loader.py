"""The port's Loader (gta_tpu_torch/data/loader.py: worker threads, a
producer thread, bounded prefetch) against the JAX package's
gta_tpu.data.loader.Loader: the same batches, field by field, in every
combination of shuffle, drop_last, workers, prefetch and shard over two
epochs, and the iterable order; an early stop leaves no thread behind; an
exception in a worker reaches the consumer (where the JAX loader ends the
epoch without a word: the port's deliberate difference)."""

import itertools
import sys
import threading
import time

import numpy as np
import pytest

from gta_tpu.data.loader import Loader as JLoader
from gta_tpu_torch.data.loader import Loader


class _Draws:
    """Items drawn from (seed, epoch, index), as the readers draw theirs,
    with the SceneBatch fields both collates stack."""

    def __init__(self, n, seed=0, raise_at=None, delay=0.0):
        self.n, self.seed, self.epoch, self.raise_at, self.delay = n, seed, 0, raise_at, delay

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def _item(self, idx):
        if idx == self.raise_at:
            raise ValueError(f"item {idx} is broken")
        time.sleep(self.delay)
        rng = np.random.RandomState(self.seed * 100003 + self.epoch * 1009 + int(idx))
        return {
            "input_images": rng.rand(2, 3, 4, 3).astype(np.float32),
            "input_camera_pos": rng.rand(2, 3).astype(np.float32),
            "input_rays": rng.rand(2, 3, 4, 3).astype(np.float32),
            "target_pixels": rng.rand(2, 5, 3).astype(np.float32),
            "target_camera_pos": rng.rand(2, 5, 3).astype(np.float32),
            "target_rays": rng.rand(2, 5, 3).astype(np.float32),
            "sceneid": np.int32(idx),
        }


class _Items(_Draws):
    """A map-style dataset."""

    def __getitem__(self, idx):
        return self._item(idx)


class _Stream(_Draws):
    """The same items as an iterable dataset (no __getitem__), in order."""

    def __iter__(self):
        return (self._item(i) for i in range(self.n))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name, value in vars(w).items():
            if value is None:
                assert getattr(g, name) is None, name
            else:
                x = getattr(g, name).numpy()
                assert x.dtype == np.asarray(value).dtype and x.tobytes() == np.asarray(value).tobytes(), name


def _live_threads():
    return {t for t in threading.enumerate() if t.is_alive()}


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)], ids=["one_shard", "shard0of2", "shard1of2"])
@pytest.mark.parametrize("workers,prefetch", list(itertools.product([1, 4], [1, 2])),
                         ids=lambda v: str(v))
@pytest.mark.parametrize("drop_last", [True, False], ids=["drop_last", "keep_last"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "in_order"])
def test_map_batches_equal_jax_loader(shuffle, drop_last, workers, prefetch, shard):
    kw = dict(shuffle=shuffle, seed=7, num_workers=workers, drop_last=drop_last, prefetch=prefetch,
              shard_index=shard[0], shard_count=shard[1])
    ours, theirs = Loader(_Items(23, seed=1), 4, **kw), JLoader(_Items(23, seed=1), 4, **kw)
    assert len(ours) == len(theirs)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(ours)
        _assert_batches_equal(got, want)


@pytest.mark.parametrize("drop_last", [True, False], ids=["drop_last", "keep_last"])
@pytest.mark.parametrize("workers,prefetch", [(1, 1), (4, 2)], ids=lambda v: str(v))
def test_iterable_batches_equal_jax_loader(drop_last, workers, prefetch):
    kw = dict(num_workers=workers, drop_last=drop_last, prefetch=prefetch)
    ours, theirs = Loader(_Stream(11), 3, **kw), JLoader(_Stream(11), 3, **kw)
    assert len(ours) == len(theirs) == 3
    got, want = list(ours), list(theirs)
    assert [b.sceneid.tolist() for b in got] == [[0, 1, 2], [3, 4, 5], [6, 7, 8]] + ([] if drop_last else [[9, 10]])
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("iterable", [False, True], ids=["map", "iterable"])
def test_early_stop_leaves_no_thread(iterable):
    """A `break` (the iterator dropped) and an explicit close, with the
    producer blocked on a full queue: the queue is drained, the producer
    and the pool's workers joined."""
    before = _live_threads()
    dataset = (_Stream if iterable else _Items)(40, delay=0.002)
    loader = Loader(dataset, 2, num_workers=4, prefetch=1)
    for i, _ in enumerate(loader):
        if i == 1:
            time.sleep(0.05)  # the producer fills the queue and blocks
            break
    assert _live_threads() - before == set()
    it = iter(loader)
    next(it)
    time.sleep(0.05)
    assert any(t.name == "Loader-producer" for t in _live_threads() - before)
    it.close()
    assert _live_threads() - before == set()


@pytest.mark.parametrize("iterable", [False, True], ids=["map", "iterable"])
def test_worker_exception_reaches_the_consumer(iterable):
    before = _live_threads()
    loader = Loader((_Stream if iterable else _Items)(20, raise_at=7), 3, shuffle=False, num_workers=4)
    got = []
    with pytest.raises(ValueError, match="item 7 is broken"):
        for batch in loader:
            got.append(batch.sceneid.tolist())
    assert got == [[0, 1, 2], [3, 4, 5]]
    assert _live_threads() - before == set()
    # the JAX loader ends the epoch at the failed batch, raising nothing
    if not iterable:
        jax_batches = list(JLoader(_Items(20, raise_at=7), 3, shuffle=False, num_workers=4))
        assert [np.asarray(b.sceneid).tolist() for b in jax_batches] == got


def test_many_workers_under_fast_switching():
    """More workers than cores, the interpreter switching threads every
    microsecond: every batch arrives once, in order, equal to the JAX
    loader's."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kw = dict(shuffle=True, seed=3, num_workers=32, prefetch=1, drop_last=False)
        t0 = time.perf_counter()
        got = list(Loader(_Items(200), 3, **kw))
        assert time.perf_counter() - t0 < 60
    finally:
        sys.setswitchinterval(interval)
    _assert_batches_equal(got, list(JLoader(_Items(200), 3, **kw)))
    assert sorted(i for b in got for i in b.sceneid.tolist()) == list(range(200))
