"""Batches of numpy samples (counterpart of matchnerf_tpu/data/loader.py).

The batch order is the JAX loader's (`_batch_indices`, loader.py:74): in
order, or with `shuffle` a permutation from `np.random.default_rng(seed +
epoch)`; the epoch is what `set_epoch` last set, and every pass over the
loader advances it by one; `drop_last` drops a short last batch. One
background thread loads up to PREFETCH batches ahead, in order, so image
decoding overlaps the device's work and a dataset's own random draws (DTU's
source permutation) happen in sample order, as with the JAX loader at
num_workers=1.

Sharding (`num_shards`, `shard_id`; loader.py:40-100): `batch_size` stays
the global batch, every rank walks the same seeded schedule and keeps its
contiguous batch_size / num_shards chunk of each batch, every partial tail
batch is dropped, and `__len__` counts the whole batches. So that a
dataset's own draws stay in step with the one-process run, a rank makes
the draws of the samples it does not load (the dataset's `skip_sample`,
where it has one) in the one-process order, tail included.
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
                 drop_last: bool = False, num_shards: int = 1, shard_id: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = max(1, int(num_shards))
        self.shard_id = int(shard_id)
        if not 0 <= self.shard_id < self.num_shards:
            raise ValueError(f"shard {self.shard_id} of {self.num_shards}")
        if batch_size % self.num_shards:
            raise ValueError(f"global batch_size {batch_size} must divide over "
                             f"{self.num_shards} shards")
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last or self.num_shards > 1:     # sharded loaders drop every tail
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _schedule(self):
        """(the epoch's sample order, its batches before sharding)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if ((self.drop_last or self.num_shards > 1) and batches
                and len(batches[-1]) < self.batch_size):
            batches.pop()
        return order, batches

    def _plan(self):
        """Per batch: (the indices this shard loads, the indices before and
        after them whose draws alone it makes), in the one-process order; a
        sharded loader's dropped tail is drawn after its last batch."""
        order, batches = self._schedule()
        k = self.batch_size // self.num_shards
        lo, hi = self.shard_id * k, (self.shard_id + 1) * k
        plan = [(b[lo:hi], b[:lo], b[hi:]) for b in batches]
        if self.num_shards > 1 and plan:
            own, before, after = plan[-1]
            tail = order[len(batches) * self.batch_size:]
            plan[-1] = (own, before, np.concatenate([after, tail]))
        return plan

    def batch_indices(self) -> List[np.ndarray]:
        """This epoch's batches of sample indices (this shard's chunks)."""
        return [own for own, _, _ in self._plan()]

    def __iter__(self) -> Iterator[Dict]:
        plan = self._plan()
        self._epoch += 1
        if not plan:
            return
        skip = getattr(self.dataset, "skip_sample", lambda i: None)
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                for own, before, after in plan:
                    if stop.is_set():
                        return
                    for i in before:
                        skip(int(i))
                    samples = [self.dataset[int(i)] for i in own]
                    for i in after:
                        skip(int(i))
                    q.put(("ok", collate(samples)))
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
