"""Batches of numpy samples (counterpart of matchnerf_tpu/data/loader.py,
single process).

The batch order is the JAX loader's (`_batch_indices`, loader.py:74): in
order, or with `shuffle` a permutation from `np.random.default_rng(seed +
epoch)`; the epoch is what `set_epoch` last set, and every pass over the
loader advances it by one; `drop_last` drops a short last batch. One
background thread loads up to PREFETCH batches ahead, in order, so image
decoding overlaps the device's work and a dataset's own random draws (DTU's
source permutation) happen in sample order, as with the JAX loader at
num_workers=1. Multi-host sharding is not carried.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

PREFETCH = 2                  # batches loaded ahead of the consumer


def collate(samples: List[Dict]) -> Dict:
    """Stack sample dicts into a batch dict (loader.py:19): arrays gain a
    leading batch axis, scalars become an array, anything else a list."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def batch_indices(self) -> List[np.ndarray]:
        """This epoch's batches of sample indices."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict]:
        batches = self.batch_indices()
        self._epoch += 1
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    q.put(("ok", collate([self.dataset[int(i)] for i in idxs])))
                q.put(("done", None))
            except Exception as e:        # handed to the consumer, raised there
                q.put(("err", e))

        worker = threading.Thread(target=produce, name="DataLoader", daemon=True)
        worker.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "done":
                    break
                if kind == "err":
                    raise item
                yield item
        finally:
            stop.set()
            while worker.is_alive():      # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            worker.join()
