"""DataLoader: the host input pipeline (counterpart of
``paddle_tpu/fluid/reader.py``).

The map-style ``DataLoader`` collates samples into numpy batches on the
host, in one process, and advertises its exact batch sizes
(``bucket_edges``) to the executor's shape bucketing.  In a program the
batches stay numpy, the ``Executor``'s feed; under a dygraph tracer each
array becomes a VarBase on the tracer's device (the card unless the
caller asked for the host) or on ``places``.  ``from_generator`` yields
feed dicts through a background prefetch thread.

Not ported yet: worker processes (``num_workers > 0``, ROADMAP queue A
item 12) and ``stacked``, the K-step staging of the async window (item
10); each raises where the reference would take it.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np


class DataLoader:
    @staticmethod
    def from_generator(feed_list=None, capacity=64, use_double_buffer=True,
                       iterable=True, return_list=False,
                       use_multiprocess=False, drop_last=True):
        return GeneratorLoader(feed_list, capacity, use_double_buffer,
                               iterable, return_list, drop_last,
                               use_multiprocess=use_multiprocess)

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True):
        return _DatasetLoader(dataset, drop_last)

    def __init__(self, dataset=None, feed_list=None, places=None,
                 return_list=False, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, timeout=0,
                 worker_init_fn=None, prefetch_factor=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate
        self.return_list = return_list
        self.feed_list = feed_list
        self.places = places
        self.batch_sampler = batch_sampler
        if batch_sampler is not None and (shuffle or drop_last
                                          or batch_size != 1):
            # the sampler owns batching: a drop_last ignored here would
            # hand a ragged last batch to a fixed-shape step
            raise ValueError(
                "DataLoader: batch_sampler is mutually exclusive with "
                "batch_size/shuffle/drop_last; configure them on the "
                "sampler")
        self.num_workers = int(num_workers)
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.prefetch_factor = prefetch_factor

    def _index_batches(self):
        if self.batch_sampler is not None:
            return [np.asarray(b) for b in self.batch_sampler]
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.shuffle(idx)
        n, bs = len(idx), self.batch_size
        end = n - n % bs if self.drop_last else n
        return [idx[i:i + bs] for i in range(0, end, bs)]

    @property
    def bucket_edges(self):
        """The exact batch sizes this loader emits: ``batch_size`` and,
        with ``drop_last=False``, the one tail; None when a batch sampler
        owns batching."""
        if self.batch_sampler is not None:
            return None
        sizes = {int(self.batch_size)}
        if not self.drop_last:
            tail = len(self.dataset) % self.batch_size
            if tail:
                sizes.add(int(tail))
        return tuple(sorted(sizes))

    def __iter__(self):
        if self.num_workers > 0:
            raise NotImplementedError(
                "DataLoader(num_workers > 0): worker processes are not "
                "ported yet (ROADMAP queue A item 12); use num_workers=0")
        place = _batch_place(self.places)
        for b in self._index_batches():
            batch = self.collate_fn([self.dataset[int(j)] for j in b])
            yield batch if place is None else _to_place(batch, place)

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def stacked(self, k, mesh=None, capacity=2):
        raise NotImplementedError(
            "DataLoader.stacked: K-step staging for the async window needs "
            "the mesh stacking of ROADMAP queue A item 10, which is not "
            "ported yet")


def _batch_place(places):
    """Where a batch goes: ``places`` (one place or the first of a list)
    when given; else the tracer's device under a dygraph tracer; else
    None, the host's numpy (a program's feed)."""
    from .framework import _dygraph_tracer
    if places is not None:
        return places[0] if isinstance(places, (list, tuple)) else places
    tracer = _dygraph_tracer()
    return tracer.place if tracer is not None else None


def _to_place(batch, place):
    from ..dygraph.base import to_variable
    if isinstance(batch, (list, tuple)):
        return [to_variable(a, place=place) for a in batch]
    return to_variable(batch, place=place)


def _default_collate(batch):
    first = batch[0]
    if isinstance(first, (tuple, list)):
        return [np.stack([np.asarray(s[i]) for s in batch])
                for i in range(len(first))]
    return np.stack([np.asarray(s) for s in batch])


class GeneratorLoader:
    """A program's loader: feed dicts from a generator, prefetched by a
    background thread."""

    def __init__(self, feed_list, capacity=64, use_double_buffer=True,
                 iterable=True, return_list=False, drop_last=True,
                 use_multiprocess=False):
        if use_multiprocess:
            raise NotImplementedError(
                "from_generator(use_multiprocess=True): a streamer process "
                "is not ported yet (ROADMAP queue A item 12)")
        self._feed_names = [v if isinstance(v, str) else v.name
                            for v in (feed_list or [])]
        self._capacity = capacity
        self._iterable = iterable
        self._return_list = return_list
        self._generator: Optional[Callable] = None
        self._places = None
        # the generator's length is unknown, so its tail may be any size;
        # set_sample_generator advertises edges
        self.bucket_edges = None

    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        def batcher():
            it = iter(reader())
            while True:
                rows = list(itertools.islice(it, batch_size))
                if len(rows) < batch_size:
                    if rows and not drop_last:
                        yield rows
                    return
                yield rows
        self._generator = lambda: (_rows_to_feed(self._feed_names, rows)
                                   for rows in batcher())
        if drop_last:
            self.bucket_edges = (int(batch_size),)
        else:
            from . import compile_cache
            self.bucket_edges = compile_cache.pow2_edges(batch_size)
        self._places = places
        return self

    def set_sample_list_generator(self, reader, places=None):
        self._generator = lambda: (_rows_to_feed(self._feed_names, rows)
                                   for rows in reader())
        self._places = places
        return self

    def set_batch_generator(self, reader, places=None):
        def gen():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    yield {n: np.asarray(b)
                           for n, b in zip(self._feed_names, batch)}
        self._generator = gen
        self._places = places
        return self

    def __iter__(self):
        if self._generator is None:
            raise RuntimeError("DataLoader: no generator set")
        from ..utils.prefetch import Prefetcher
        for item in Prefetcher(self._generator(), capacity=self._capacity):
            if self._return_list:
                yield [item[n] for n in self._feed_names]
            else:
                yield item

    def stacked(self, k, mesh=None, capacity=2):
        return DataLoader.stacked(self, k, mesh, capacity)

    # the non-iterable protocol
    def start(self):
        self._it = iter(self)

    def reset(self):
        self._it = None

    def next(self):
        return next(self._it)


def _rows_to_feed(names, rows):
    return {n: np.stack([np.asarray(r[i]) for r in rows])
            for i, n in enumerate(names)}


class _DatasetLoader:
    def __init__(self, dataset, drop_last=True):
        self.dataset = dataset
        self.drop_last = drop_last

    def __iter__(self):
        yield from self.dataset._iter_batches()


def batch(reader, batch_size, drop_last=False):
    """paddle.batch: a reader of lists of ``batch_size`` samples."""
    def batched():
        it = iter(reader())
        while True:
            rows = list(itertools.islice(it, batch_size))
            if not rows or (len(rows) < batch_size and drop_last):
                return
            yield rows
    return batched


def shuffle(reader, buf_size):
    def shuffled():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                np.random.shuffle(buf)
                yield from buf
                buf = []
        np.random.shuffle(buf)
        yield from buf
    return shuffled


default_collate_fn = _default_collate
