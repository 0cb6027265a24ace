"""The training log lines and the iteration timer (counterpart of
matchnerf_tpu/utils/logging.py: `get_time`, `update_timer`, `loss_train`),
on Python `logging` instead of coloured prints."""
from __future__ import annotations

import logging
import time


def get_time(sec: float):
    """Seconds -> (days, hours, minutes, seconds)."""
    return (int(sec // (24 * 60 * 60)), int(sec // (60 * 60) % 24), int((sec // 60) % 60),
            int(sec % 60))


def _hms(sec: float) -> str:
    return "{0}-{1:02d}:{2:02d}:{3:02d}".format(*get_time(sec))


def update_timer(timer: dict, max_epoch: int, ep: int, it_per_ep: int,
                 momentum: float = 0.99):
    """Elapsed time, the last iteration's time, its moving mean and the time
    to the end of training (logging.py:85)."""
    timer["elapsed"] = time.time() - timer["start"]
    timer["it"] = timer["it_end"] - timer["it_start"]
    prev = timer.get("it_mean")
    timer["it_mean"] = (prev * momentum + timer["it"] * (1 - momentum)
                        if prev is not None else timer["it"])
    timer["arrival"] = timer["it_mean"] * it_per_ep * (max_epoch - ep)


def loss_train(log: logging.Logger, max_epoch, ep, lr_dict, loss, timer):
    """One line per epoch: epoch, learning rates, loss, time and ETA
    (logging.py:61)."""
    msg = f"[train] epoch {ep}/{max_epoch}"
    for k, v in lr_dict.items():
        msg += f", lr_{k}:{v:.2e}"
    msg += f", loss:{loss:.3e}"
    if timer.get("elapsed") is not None:
        msg += f", time:{_hms(timer['elapsed'])}"
    if timer.get("arrival") is not None:
        msg += f" (ETA:{_hms(timer['arrival'])})"
    log.info(msg)
