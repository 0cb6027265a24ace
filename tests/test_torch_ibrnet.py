"""configs/train_ibrnet.yaml in the port, against the JAX package, on the CPU
(its training step: tests/test_torch_ibrnet_step.py).

- The IBRNet loader (`data/llff.py::IBRNetDataset`) against the JAX one,
  item by item, on a tree of `synth.write_ibrnet_tree` (two groups of one
  scene, 8 views each), in the train and val splits; two passes over the
  train split compare the random source draws of both datasets' own
  generators too, and the port's loader yields the JAX loader's batches
  (shuffled order and draws) over two epochs.
- `CONFIGS["train_ibrnet"]` against the JAX `build_options` of
  configs/train_ibrnet.yaml, every key.
- The encoder at 756x1008, the one size where it resizes its input (to
  768x1024, so windows of 24 x 32 = 768 tokens at attn_splits 4): the
  resize alone within 1e-4, then the whole encode, both sides in f32 from
  the same weights on a real sample of the synthetic tree, 1 transformer
  layer, the JAX xla attention backend (the same function as its kernels;
  Pallas interpret mode at this size takes minutes), max |d| within 5e-4
  and mean |d| within 5e-6 of each scale's largest magnitude (the reasons
  are in the tests).
- The training route's grids: `Coach.train_route` measures the block
  unions on the tables' own grids (96x128 and 192x256 at 756x1008), not
  on (H // 8, W // 8) as the JAX package does, which can give a bucket
  the tables' union overflows.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matchnerf_tpu.data as jdata
from ibrnet_common import H, SMALL_WH, W, full_sample, jax_cfg, port_model, small_tree  # noqa: F401
from matchnerf_tpu import config as jconfig
from matchnerf_tpu.data.loader import DataLoader as JaxDataLoader
from matchnerf_tpu.models.matchnerf import encode as jax_encode
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.ops.resize import resize_bilinear_align_corners as jax_resize
from matchnerf_tpu.utils import DotDict as JDotDict
from matchnerf_tpu.utils import to_plain_dict
from matchnerf_tpu_torch import camera
from matchnerf_tpu_torch.config import CONFIGS
from matchnerf_tpu_torch.data import DATASETS
from matchnerf_tpu_torch.data.loader import DataLoader
from matchnerf_tpu_torch.engine import Coach
from matchnerf_tpu_torch.models.matchnerf import encode, project_to_views, sample_depth
from matchnerf_tpu_torch.ops.block_cosine_prior import block_union_max, bucket_ut
from matchnerf_tpu_torch.ops.resize import resize_bilinear_align_corners
from matchnerf_tpu_torch.renderer import Renderer, extract_poses
from torch_threads import one_torch_thread  # noqa: F401


def _assert_samples_equal(a, b, tag):
    assert sorted(a) == sorted(b), tag
    assert "c2ws_all" not in a and a["scene"] == b["scene"], tag
    for k in a:
        if k == "scene":
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (tag, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{tag} {k}")


@pytest.mark.parametrize("split", ["train", "val"])
def test_ibrnet_loader_matches_jax(small_tree, split):
    mine = DATASETS["ibrnet"](small_tree, split, n_views=3, img_wh=SMALL_WH)
    theirs = jdata.datas_dict["ibrnet"](small_tree, split, n_views=3, img_wh=SMALL_WH)
    assert mine.get_name() == theirs.get_name() == "ibrnet"
    # 2 scenes x 8 views: every view a target in train, view 0 in val
    assert len(mine) == len(theirs) == (16 if split == "train" else 2)
    assert mine.metas == theirs.metas
    assert [m[0] for m in mine.metas[::len(mine) // 2]] == [
        "ibrnet_collected_1_scene0", "real_iconic_noface_scene1"]
    for rep in range(2):                   # train: the second pass draws anew
        for i in range(len(mine)):
            _assert_samples_equal(mine[i], theirs[i], f"{split} pass {rep} [{i}]")
    if split == "train":                   # the draws differ between passes
        first = DATASETS["ibrnet"](small_tree, split, img_wh=SMALL_WH)
        views = [tuple(first[0]["view_ids"]) for _ in range(8)]
        assert len(set(views)) > 1


def test_ibrnet_loader_batches_match_jax(small_tree):
    """The port's loader (shuffled per epoch, one thread ahead) yields the
    JAX loader's batches, source draws included, over two epochs."""
    mine = DataLoader(DATASETS["ibrnet"](small_tree, "train", img_wh=SMALL_WH), 1,
                      shuffle=True, seed=0)
    theirs = JaxDataLoader(jdata.datas_dict["ibrnet"](small_tree, "train", img_wh=SMALL_WH),
                           batch_size=1, shuffle=True, num_workers=1, seed=0)
    for epoch in range(2):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == 16
        for i, (a, b) in enumerate(zip(got, want)):
            assert a["scene"] == list(b["scene"]), (epoch, i)
            np.testing.assert_array_equal(a["view_ids"], b["view_ids"], err_msg=f"{epoch} {i}")
            np.testing.assert_array_equal(a["images"], b["images"], err_msg=f"{epoch} {i}")


def test_config_matches_yaml():
    want = to_plain_dict(jconfig.build_options(JDotDict(yaml="train_ibrnet")))
    got = json.loads(json.dumps(CONFIGS["train_ibrnet"]()))
    assert got == want
    assert got["encoder"]["attn_splits_list"] == [4]
    assert got["data_test"]["llff"]["eval_mode"] == "gpnr"


def test_resize_756x1008_matches_jax(full_sample):
    """The 756x1008 -> 768x1024 align-corners resize on the sample's
    images. The lattices differ in the last bit: jnp.linspace, compiled,
    rounds some of its 1024 points one f32 ulp away from torch.linspace
    (XLA divides by the reciprocal and contracts the sum), which moves a
    sample point by up to 3e-5 pixel; so 1e-4 of the [0, 1] range."""
    imgs = np.asarray(full_sample["images"][0, :3])
    ref = np.asarray(jax_resize(jnp.asarray(imgs), 768, 1024))
    got = resize_bilinear_align_corners(torch.tensor(imgs), 768, 1024).numpy()
    assert got.shape == ref.shape == (3, 768, 1024, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_encode_756x1008_matches_jax(full_sample):
    """The whole encode at 756x1008, its resize included. Max |d| within
    5e-4 of each scale's largest magnitude and mean |d| within 5e-6 (measured
    1.3e-4 and 1.6e-6 at scale 0): the resize's last-bit lattice differences
    above, and the f32 sums of a 768x1024 backbone and 768-token softmax,
    which alone reach 2e-5 of the scale (the same lattice on both sides)."""
    cfg = jax_cfg()
    params = jax_init(jax.random.PRNGKey(0), cfg)
    model = port_model(cfg, params)
    imgs = np.asarray(full_sample["images"][:, :3])
    assert imgs.shape == (1, 3, H, W, 3)
    ref = jax_encode(params, cfg, jnp.asarray(imgs))
    with torch.no_grad():
        got = encode(model, cfg, torch.tensor(imgs))
    # the 768x1024 encoder input: 96x128 and 192x256 feature maps
    assert [tuple(g.shape) for g in got] == [(1, 3, 2, 96, 128, 128), (1, 3, 2, 192, 256, 128)]
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        scale = float(np.abs(r).max())
        err = np.abs(g.numpy() - r)
        assert err.max() <= 5e-4 * scale and err.mean() <= 5e-6 * scale, (
            err.max() / scale, err.mean() / scale)


def test_train_route_measures_the_tables_grids(full_sample, monkeypatch):
    """train_ibrnet with nerf.train_ray_patches: `Coach.train_route`
    measures the pose's unions on the tables' grids, 96x128 / 192x256 at
    756x1008 (an image the encoder does not resize keeps H // 8). The JAX
    grids, 94x126 / 188x252, can give a bucket the tables' union
    overflows: on this pose (the tree's first training sample, S = 16),
    the largest scale-0 union is 64 rows on the JAX grid (bucket 64) and
    65 on the tables' grid (measured over the whole image); the rays of
    pose_prep's 8192-ray chunk 72 hold such a block, 61 rows on the JAX
    grid and 65 on the tables'."""
    cfg = CONFIGS["train_ibrnet"]()
    cfg.nerf.train_ray_patches = True
    cfg.nerf.sample_intvs = 16
    batch = {k: full_sample[k] for k in ("extrinsics", "intrinsics", "near_fars")}
    assert list(full_sample["view_ids"][0]) == [2, 5, 6, 0]
    seen = []
    monkeypatch.setattr(Renderer, "pose_prep",
                        lambda self, poses, scale_hws, *a, **k: seen.append(scale_hws)
                        or (None, None))
    for hw in ((H, W), (512, 640)):
        coach = Coach(cfg, None, "cpu")
        coach.train_hw = (*hw, 1024)
        assert coach.train_route(batch) is None
    assert seen == [[(96, 128), (192, 256)], [(64, 80), (128, 160)]]
    monkeypatch.undo()

    r = Renderer(cfg, None, "cpu")
    tgt_intr, c2w, tgt_nf, ref_w2c, ref_intr, ref_nf = r._pose_tensors(extract_poses(batch))
    R = 8192
    pix = camera.pixel_grid(H, W, legacy=True)[72 * R:73 * R][None]
    center, ray = camera.get_center_and_ray(pix, tgt_intr, c2w)
    pts = camera.get_3d_points_from_depth(center, ray, sample_depth(cfg, tgt_nf, 1, R),
                                          multi_samples=True)
    grids = project_to_views(pts, ref_w2c, ref_intr, ref_nf, H, W)[:, 0, ..., :2] * 2.0 - 1.0
    jax_union = int(block_union_max(grids, 94, 126))
    table_union = int(block_union_max(grids, 96, 128))
    assert (jax_union, table_union) == (61, 65)
    assert bucket_ut(jax_union) == 64 < table_union
