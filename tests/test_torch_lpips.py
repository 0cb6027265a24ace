"""LPIPS (VGG) in the port (`matchnerf_tpu_torch.lpips`, `metrics.lpips_vgg`)
against the JAX package's `lpips_jax.lpips_distance`, on the CPU.

The VGG16 + LPIPS weights are not in the repository, so both packages read
the same seeded weights from a temporary npz in the file's layout (HWIO
convolutions, VGG16's channel widths, positive `lin{i}`): each module's
`_CACHE` points at it (monkeypatch) and its cached state is cleared, which
edits nothing in either package. The distance atol 1e-5 (it is ~0.1-1
here), also through `EvalTools`; without the file both report NaN, the port
with one warning per process.
"""
import logging

import numpy as np
import pytest

from matchnerf_tpu import lpips_jax
from matchnerf_tpu import metrics as jmetrics
from matchnerf_tpu_torch import lpips, metrics
from torch_threads import one_torch_thread  # noqa: F401

PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def _write_weights(path, seed=0):
    rng = np.random.default_rng(seed)
    arrays, c_in, i = {}, 3, 0
    for c_out, n in PLAN:
        for _ in range(n):
            std = np.sqrt(2.0 / (9 * c_in))
            arrays[f"conv{i}_w"] = rng.normal(0, std, (3, 3, c_in, c_out)).astype(np.float32)
            arrays[f"conv{i}_b"] = rng.normal(0, 0.05, c_out).astype(np.float32)
            c_in, i = c_out, i + 1
    for s, (c, _) in enumerate(PLAN):
        arrays[f"lin{s}"] = rng.uniform(0, 0.1, c).astype(np.float32)
    np.savez(path, **arrays)
    return str(path)


@pytest.fixture
def weights(tmp_path, monkeypatch):
    path = _write_weights(tmp_path / "lpips_vgg_weights.npz")
    monkeypatch.setattr(lpips_jax, "_CACHE", path)
    monkeypatch.setattr(lpips_jax, "_state", {})
    monkeypatch.setattr(lpips, "_CACHE", path)
    monkeypatch.setattr(lpips, "_state", {})
    return path


def _pair(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_lpips_matches_jax(weights, seed):
    pred, gt = _pair(seed)
    want = lpips_jax.lpips_distance(pred, gt)
    got = lpips.lpips_distance(pred, gt, "cpu")
    assert 1e-3 < want < 10.0
    assert abs(got - want) <= 1e-5, (got, want)
    assert lpips.lpips_distance(pred, pred, "cpu") == 0.0
    assert abs(metrics.lpips_vgg(pred, gt, "cpu") - want) <= 1e-5


def test_eval_tools_lpips_matches_jax(weights):
    pred, gt = _pair(2, 50, 60)
    mask = np.random.default_rng(3).uniform(0, 1, (50, 60)) < 0.3
    for m in (None, mask):
        a, b = metrics.EvalTools("cpu"), jmetrics.EvalTools()
        a.set_inputs(pred, gt, m)
        b.set_inputs(pred, gt, m)
        got = a.get_metrics(["LPIPS"], return_full=True)
        want = b.get_metrics(["LPIPS"], return_full=True)
        assert got.keys() == want.keys()
        for k in got:
            assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])


def test_lpips_without_weights_is_nan_with_one_warning(tmp_path, monkeypatch, caplog):
    missing = str(tmp_path / "absent.npz")
    monkeypatch.setattr(lpips, "_CACHE", missing)
    monkeypatch.setattr(lpips, "_state", {})
    monkeypatch.setattr(metrics, "_lpips_warned", False)
    monkeypatch.setattr(lpips_jax, "_CACHE", missing)
    monkeypatch.setattr(lpips_jax, "_state", {})
    pred, gt = _pair(4, 24, 24)
    with caplog.at_level(logging.WARNING, logger=metrics.log.name):
        tools = metrics.EvalTools("cpu")
        tools.set_inputs(pred, gt)
        values = [tools.get_metrics(["LPIPS"])["LPIPS"] for _ in range(3)]
    assert all(np.isnan(v) for v in values)
    warnings = [r for r in caplog.records if "LPIPS unavailable" in r.getMessage()]
    assert len(warnings) == 1
    jtools = jmetrics.EvalTools()
    jtools.set_inputs(pred, gt)
    assert np.isnan(jtools.get_metrics(["LPIPS"])["LPIPS"])


def test_lpips_needs_a_device(weights, tmp_path, monkeypatch):
    """No silent CPU default: `lpips_distance` and `EvalTools` take the
    device, and `score_preds` scores on the card unless given `--cpu`."""
    import torch

    from matchnerf_tpu_torch import score_preds
    pred, gt = _pair(0, 24, 24)
    with pytest.raises(TypeError, match="needs a device"):
        lpips.lpips_distance(pred, gt, None)
    with pytest.raises(TypeError):
        metrics.EvalTools()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="pass --cpu"):
        score_preds.main([f"--pred_folder={tmp_path}"])
