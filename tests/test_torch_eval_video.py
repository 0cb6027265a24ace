"""The video entry of the port with configs/test_video.yaml, against the JAX
package, on the CPU: `python -m matchnerf_tpu_torch.test --config
test_video --cpu` (its `main`) with 3 frames on the synthetic LLFF tree
(the spiral around the train views) and Blender tree (interpolated between
the source cameras, onto a white background) of test_torch_eval_entry.py,
against the JAX `Coach.test_model_video` of the same weights: each frame
>= 60 dB agreement PSNR, the same path mode and background on both sides.

The interpolated path's frames are the source cameras' own poses (3 frames
between 3 sources: the weights start at 1). Then the border pixels of a
frame project onto the exact border of its source view, where the strict
in-frustum mask flips on the last bit of either framework's projection;
as in test_torch_video.py, the Blender target's principal point moves by a
sub-pixel offset (0.37, 0.29) on both sides, which keeps those rays off
the border.
"""
import os

import numpy as np

import matchnerf_tpu.data.blender as jblender
import matchnerf_tpu_torch.data.blender as tblender
from test_torch_eval_entry import (SMALL, _one_torch_thread, _psnr, _run_both,  # noqa: F401
                                   trees)


def _shift_target_pp(cls):
    getitem = cls.__getitem__

    def shifted(self, idx):
        sample = getitem(self, idx)
        sample["intrinsics"] = sample["intrinsics"].copy()
        sample["intrinsics"][-1, :2, 2] += (0.37, 0.29)
        return sample
    return shifted


def test_entry_video_matches_jax(tmp_path, trees, monkeypatch):  # noqa: F811
    for cls in (jblender.BlenderDataset, tblender.BlenderDataset):
        monkeypatch.setattr(cls, "__getitem__", _shift_target_pp(cls))
    sets = ("llff", "blender")
    got, want, renders = _run_both(tmp_path, trees, "test_video", sets,
                                   **{"nerf.video_n_frames": 3})
    for name, (port, psetbg, _), (ref, jsetbg) in zip(sets, renders["port"],
                                                      renders["jax"]):
        assert psetbg == jsetbg == (name == "blender"), name
        assert port.shape == ref.shape and port.shape[0] == 3
        for f in range(3):
            psnr = _psnr(port[f], ref[f])
            assert psnr >= 60.0, f"{name} frame {f}: agreement PSNR {psnr:.1f} dB < 60"
    assert len(got) == 2 and all(v.shape == (3, SMALL[1], SMALL[0], 3) for v in got)
    for name in sets:
        assert os.path.isdir(tmp_path / "port" / "test_videos" / name)
    assert np.isfinite(got[1]).all()
