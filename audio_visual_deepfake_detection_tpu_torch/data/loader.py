"""Threaded prefetching data loader (JAX ``data/loader.py``).

Loading a sample is numpy file IO and a resample, both of which release the
interpreter lock, so a thread pool with a bounded queue keeps the card fed
without pickling anything. Shuffling and the per-sample randomness come from
a ``numpy.random.Generator`` seeded per epoch: the same seed gives the same
batches in the same order as the JAX package's loader.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate: Callable,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 2,
        shard_rank: int = 0,
        num_shards: int = 1,
        equal_shards: bool = False,
    ):
        """``shard_rank`` / ``num_shards``: every process draws the same
        seeded epoch order and keeps its strided slice, so the processes
        together cover the dataset once.

        ``equal_shards``: cut every slice to the shortest one
        (``len(dataset) // num_shards``). Training needs it: slices that
        differ by one item can give one process an extra batch, and a process
        still in a train step's collectives after its peers stopped hangs.
        Inference, which has no collectives and must not drop videos, leaves
        it off."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.shard_rank = shard_rank
        self.num_shards = max(1, num_shards)
        self.equal_shards = equal_shards
        self._epoch = 0
        self._skip = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def set_skip(self, n: int):
        """Skip the first ``n`` batches of the next iteration only (a
        mid-epoch resume). Skipped batches are never loaded or collated, but
        their per-sample random draws are consumed, so the batches that
        follow equal those of an unskipped run."""
        self._skip = n

    def _shard_order(self):
        order = np.arange(len(self.dataset))
        rng = np.random.default_rng(self.seed + self._epoch)
        if self.shuffle:
            rng.shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_rank::self.num_shards]
            if self.equal_shards:
                order = order[:len(self.dataset) // self.num_shards]
        return order

    def __len__(self) -> int:
        # arithmetic: building and shuffling the order only to count it is
        # O(N) a call
        n = len(self.dataset)
        if self.num_shards > 1:
            if self.equal_shards:
                n = n // self.num_shards
            else:
                n = (n - self.shard_rank + self.num_shards - 1) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        order = self._shard_order()
        n = len(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, end, self.batch_size):
            yield order[i:i + self.batch_size]

    def __iter__(self) -> Iterator:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        rng_root = np.random.default_rng((self.seed + self._epoch) * 7919 + 13)
        skip_batches = self._skip  # one-shot, consumed by this iteration
        self._skip = 0

        stop = threading.Event()

        def put(item) -> bool:
            """A bounded put that gives up once the consumer has abandoned
            the iterator (a preemption return, a break); otherwise the
            producer would wait on the full queue for ever, holding its pool
            and several collated batches."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # any exception in the producer goes to the consumer, which would
            # otherwise wait on out_q.get() for ever
            try:
                skip = skip_batches
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in self._batches():
                        seeds = rng_root.integers(0, 2**63, size=len(batch_idx))
                        if skip > 0:
                            skip -= 1
                            continue
                        if stop.is_set():
                            return
                        futures = [
                            pool.submit(self.dataset.__getitem__, int(i),
                                        np.random.default_rng(int(s)))
                            for i, s in zip(batch_idx, seeds)
                        ]
                        samples = [f.result() for f in futures]
                        if not put(self.collate(samples)):
                            return
                put(sentinel)
            except BaseException as exc:  # noqa: BLE001 - handed to the consumer, raised there
                put(exc)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    thread.join()
                    raise item
                yield item
            thread.join()
        finally:
            # the consumer left early (break, preemption, GC): release the
            # producer and its pool
            stop.set()
