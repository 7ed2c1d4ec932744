"""Samplers and a host data loader; counterpart of log_tpu/utils/sampler.py.

`IterationBasedSampler` draws dataset indices from its own numpy Generator
(the trainer seeds it), so one seed gives the JAX package's order. The
loader collates numpy batches (camera dicts stacked key-wise); a prefetch
thread overlaps image decoding with the device's work.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class IterationBasedSampler:
    """Uniform random draws for exactly `iterations` steps."""

    def __init__(self, dataset, iterations, index=None, seed=None):
        self.index = np.arange(len(dataset)) if index is None else np.asarray(index)
        self.iterations = iterations
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.iterations

    def __iter__(self):
        for _ in range(self.iterations):
            yield int(self.rng.choice(self.index))


class IndexSampler:
    def __init__(self, dataset, index=None):
        self.index = np.arange(len(dataset)) if index is None else np.asarray(index)

    def __len__(self):
        return len(self.index)

    def __iter__(self):
        return iter(int(i) for i in self.index)


def default_collate(items):
    """Stack a list of dataset dicts into a batch dict (numpy)."""
    batch = {}
    for key in items[0].keys():
        vals = [it[key] for it in items]
        if isinstance(vals[0], dict):
            batch[key] = default_collate(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            batch[key] = np.asarray(vals)
        elif isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        else:
            batch[key] = vals
    return batch


class DataLoader:
    """Minimal map-style loader: sampler -> collate, optional prefetching."""

    def __init__(self, dataset, sampler=None, batch_size=1, prefetch=2,
                 drop_last=False, num_workers=0):
        self.dataset = dataset
        self.sampler = sampler if sampler is not None else IndexSampler(dataset)
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        buf = []
        for idx in self.sampler:
            buf.append(self.dataset[idx])
            if len(buf) == self.batch_size:
                yield default_collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield default_collate(buf)

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        failed = []

        def worker():
            try:
                for batch in self._batches():
                    q.put(batch)
            except Exception as exc:  # handed to the consumer below
                failed.append(exc)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is sentinel:
                break
            yield batch
        t.join()
        if failed:
            raise failed[0]
