"""Batches of numpy samples (counterpart of matchnerf_tpu/data/loader.py,
single process: the eval entry loads a handful of samples, so the JAX
package's threaded prefetch and multi-host sharding are not carried)."""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


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
    """In-order batches of `batch_size` samples, the last one ragged."""

    def __init__(self, dataset, batch_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict]:
        n = len(self.dataset)
        for i in range(0, n, self.batch_size):
            yield collate([self.dataset[j] for j in range(i, min(i + self.batch_size, n))])
