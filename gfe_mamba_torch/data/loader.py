"""Batching, prefetching data loader (counterpart of
``gfe_mamba_tpu/data/loader.py``).

A thread pool decodes and preprocesses items on the host while the card
computes; a producer thread keeps ``prefetch`` batches in flight.  The
batches are numpy; the trainers move them to the card.  The shuffle
order is the JAX loader's, ``np.random.default_rng(seed + epoch)`` with
the epoch counted from 1, so both packages see the same batches in the
same order.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


def _collate(items: list[dict]) -> dict:
    batch = {}
    for key in items[0]:
        values = [item[key] for item in items]
        if isinstance(values[0], (str, bytes)):
            batch[key] = values
        else:
            batch[key] = np.stack([np.asarray(v) for v in values])
    return batch


class DataLoader:
    """Iterable over collated numpy batches with shuffle/drop_last
    semantics.

    Args:
      dataset: indexable with ``__len__`` returning dict items
      batch_size, shuffle, drop_last: torch DataLoader semantics
      num_workers: decode threads (0 = synchronous)
      prefetch: batches to keep in flight (>=1 enables the background
        producer thread)
      seed: shuffle seed; epoch counter advances it deterministically
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 0,
                 prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        # seconds the consumer waited for its batches, and their count
        self.wait_s, self.batches = 0.0, 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield chunk

    def _load_batch(self, indices, pool: Optional[ThreadPoolExecutor]):
        # dataset-level batch fast path (e.g. the C++ threaded NIfTI
        # decoder, MRIClassifyDataset.load_batch); returns None when
        # unavailable -> per-item decode below
        batch = None
        fast = getattr(self.dataset, "load_batch", None)
        if fast is not None:
            batch = fast(indices)
        if batch is None:
            if pool is not None:
                items = list(pool.map(self.dataset.__getitem__, indices))
            else:
                items = [self.dataset[int(i)] for i in indices]
            batch = _collate(items)
        return batch

    def _waited(self, since: float) -> None:
        self.wait_s += time.perf_counter() - since
        self.batches += 1

    def __iter__(self) -> Iterator[dict]:
        self.epoch += 1
        pool = (ThreadPoolExecutor(self.num_workers)
                if self.num_workers > 0 else None)
        try:
            if self.prefetch <= 0:
                for indices in self._index_batches():
                    t = time.perf_counter()
                    batch = self._load_batch(indices, pool)
                    self._waited(t)
                    yield batch
                return

            out: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
            sentinel = object()

            def producer():
                try:
                    for indices in self._index_batches():
                        out.put(self._load_batch(indices, pool))
                except BaseException as exc:  # surface in consumer
                    out.put(exc)
                finally:
                    out.put(sentinel)

            thread = threading.Thread(target=producer, daemon=True)
            thread.start()
            while True:
                t = time.perf_counter()
                item = out.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                self._waited(t)
                yield item
            thread.join()
        finally:
            if pool is not None:
                pool.shutdown(wait=False)
