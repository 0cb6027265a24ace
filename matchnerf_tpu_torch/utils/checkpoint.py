"""Training checkpoints (counterpart of matchnerf_tpu/utils/checkpoint.py),
in the port's own format: `torch.save` of a dict of state dicts.

`<output_path>/models/latest.ckpt` holds {"model": the model's state_dict,
"optim": the optimizer's (`TrainOptimizer.state_dict`: AdamW state and the
schedule's step count), "epoch", "iter"} for resuming; a backup
`ep{epoch}_it{iter}.ckpt` beside it holds the weights, epoch and iter only.
Every file is written to `<name>.tmp` and renamed, so a run stopped while
writing never leaves a torn checkpoint. With `async_write` (the frequent
mid-epoch saves) the state is serialised on the caller, a consistent
snapshot whatever the training does next, and only the file writes run on
the writer's one background thread. Loading a reference `.pth` is
`engine.Coach.restore_checkpoint_if_needed`'s.
"""
from __future__ import annotations

import io
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch


def _write_atomic(path: str, payload: bytes):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def _serialise(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


class CheckpointWriter:
    """Writes checkpoints; owns the background thread of the asynchronous
    writes. `wait()` blocks until every pending write is on disk and raises
    the first error one met."""

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []

    def save(self, output_path: str, checkpoint: Dict[str, Any], ep: int, it: int,
             backup_ckpt: bool = True, async_write: bool = False):
        ckpt_dir = os.path.join(output_path, "models")
        os.makedirs(ckpt_dir, exist_ok=True)
        checkpoint = dict(checkpoint, epoch=int(ep), iter=int(it))
        jobs = [(os.path.join(ckpt_dir, "latest.ckpt"), _serialise(checkpoint))]
        if backup_ckpt:
            slim = {k: v for k, v in checkpoint.items() if k != "optim"}
            jobs.append((os.path.join(ckpt_dir, f"ep{ep}_it{it}.ckpt"), _serialise(slim)))
        if not async_write:
            self.wait()               # an older pending write must not land after this one
            for path, payload in jobs:
                _write_atomic(path, payload)
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._pending += [self._pool.submit(_write_atomic, p, d) for p, d in jobs]

    def wait(self):
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint this package wrote, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
