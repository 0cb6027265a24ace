"""Attribute-access dict for configs, and the precision accessor.

The port's own copy of matchnerf_tpu/utils/containers.py (`DotDict` and
`effective_precision` with the `strict` override), so that the port imports
nothing of the JAX package.
"""
from __future__ import annotations

from typing import Any, Mapping


class DotDict(dict):
    """dict subclass with attribute read/write access, recursive on assignment."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        src: dict = dict(*args, **kwargs)
        for k, v in src.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, Mapping) and not isinstance(value, DotDict):
            value = DotDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                DotDict(v) if isinstance(v, Mapping) and not isinstance(v, DotDict) else v
                for v in value
            )
        super().__setitem__(key, value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        self[name] = value

    def __delattr__(self, name: str):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def copy(self) -> "DotDict":
        return DotDict(self)


# precision.strict=true collapses every lossy / fast-path knob to the
# parity configuration in one switch: f32 sampling/colour tables, f32
# encoder + decoder, direct cond query (no banded/block/fused kernels), plain
# decoder.
_STRICT_PRECISION = {
    "cond_sample_dtype": "float32",
    "color_sample_dtype": "float32",
    "encoder_compute_dtype": "float32",
    "decoder_compute_dtype": "float32",
    "decoder_matmul_dtype": "float32",
    "banded_kernel": False,
    "block_kernel": False,
    "color_block_kernel": False,
    "banded_gather": False,
    "decoder_kernel": False,
    "fused_cosine": False,
    "lanemajor_cond": False,
}


def effective_precision(cfg: Any) -> Any:
    """The precision section of `cfg` with `strict: true` resolved: whatever
    fast-path keys a config sets, `precision.strict: true` overrides them
    all at read time."""
    prec = cfg.get("precision") if hasattr(cfg, "get") else None
    prec = prec or {}
    if hasattr(prec, "get") and bool(prec.get("strict", False)):
        out = DotDict(prec)
        out.update(_STRICT_PRECISION)
        return out
    return prec
