"""`python -m matchnerf_tpu_torch.test --config test_video_own --cpu` (its
`main`) at a tiny size on the CPU: the port alone, no JAX render, in a file
of its own so that it runs beside test_torch_video.py's JAX videos.
"""
import os

import numpy as np

from torch_threads import one_torch_thread  # noqa: F401


def test_entry_test_video_own(tmp_path):
    """`python -m matchnerf_tpu_torch.test --config test_video_own --cpu
    --load=` at a tiny size (S = 256 kept, 64x32): 5012-ray slices are not
    8-aligned, so the pose takes Kernel B's and the colour gather's plain
    versions, as on the card."""
    from matchnerf_tpu_torch.test import main
    videos = main(["--config", "test_video_own", "--cpu", "--load=",
                   f"--output_root={tmp_path}", "--data_test.colmap.img_wh=64,32",
                   "--nerf.video_n_frames=2", "--encoder.num_transformer_layers=1"])
    assert len(videos) == 1 and videos[0].shape == (2, 32, 64, 3)
    assert np.isfinite(videos[0]).all() and 0.0 <= videos[0].min() <= videos[0].max() <= 1.0
    out_dir = os.path.join(tmp_path, "test_video", "colmap_own", "test_videos", "colmap")
    assert any(f.startswith("printer_view00") for f in os.listdir(out_dir))
