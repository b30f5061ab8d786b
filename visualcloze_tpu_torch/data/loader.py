"""Threaded prefetching data loader.

A copy of visualcloze_tpu/data/loader.py, kept here so that the port imports
nothing of the JAX package.

Replaces the reference's torch DataLoader (train.py:516-525): pulls dataset
items on a worker thread pool and prefetches ahead of the accelerator —
host-side CPU work overlaps device steps. No torch dependency.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence


class DataLoader:
    """Iterate `sampler` indices, fetch dataset[i] on `num_workers` threads,
    group into batches with `collate_fn`, keep `prefetch` batches ready."""

    def __init__(
        self,
        dataset,
        sampler: Sequence[int],
        batch_size: int,
        collate_fn: Callable,
        num_workers: int = 4,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.sampler = list(sampler)
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return len(self.sampler) // self.batch_size

    def __iter__(self) -> Iterator:
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up once the consumer is gone. A plain
            blocking put would pin the producer thread (and the prefetched
            batches it holds) forever after an early consumer exit — stop is
            only observable between put attempts."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    batches = [
                        self.sampler[i : i + self.batch_size]
                        for i in range(0, len(self.sampler) - self.batch_size + 1, self.batch_size)
                    ]
                    futures_iter = (
                        [pool.submit(self.dataset.__getitem__, i) for i in batch]
                        for batch in batches
                    )
                    for futs in futures_iter:
                        if stop.is_set():
                            return
                        if not put(self.collate_fn([f.result() for f in futs])):
                            return
            except BaseException as e:
                # forward dataset/collate errors to the consumer — swallowed,
                # they would surface as a clean end-of-data (a bare
                # StopIteration mid-training) with the root cause lost to an
                # unrelated thread traceback on stderr
                put(_Raise(e))
            finally:
                put(_SENTINEL)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, _Raise):
                    raise item.exc
                yield item
        finally:
            stop.set()
            while True:  # free buffered batches; unblocks a mid-put producer
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break


class _Raise:
    """Producer-side exception carrier (re-raised in the consumer)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_SENTINEL = object()
