"""Profiling hooks (counterpart of matchnerf_tpu/utils/profiling.py).

- `trace(logdir)`: a context manager around a `torch.profiler` profile (the
  CPU, and the card's kernels where CUDA is available) that writes a Chrome
  trace (`trace_<host>_<pid>_<time>.json`, readable in chrome://tracing or
  Perfetto) into `logdir` when the block ends. The training entry wraps its
  epochs in one under `profile_trace_dir` (engine.py:361-365).
- `annotate(name)`: a named host range in that trace
  (`torch.profiler.record_function`).
- `Stopwatch`: named phase timers summed into a report (totals, counts,
  means), in the JAX package's format.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """Profile the block; on exit write the Chrome trace into `logdir`
    (created if missing). Yields the path the trace will be written to."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{socket.gethostname()}_{os.getpid()}_"
                                f"{time.strftime('%Y%m%d_%H%M%S')}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def annotate(name: str):
    from torch.profiler import record_function
    return record_function(name)


class Stopwatch:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} total {t:8.3f}s  n={n:5d}  mean {t/max(n,1)*1000:8.2f}ms")
        return "\n".join(lines)
