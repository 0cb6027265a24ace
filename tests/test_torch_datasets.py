"""The port's LLFF, Blender and T&T test-set loaders against the JAX
package's, item by item, on the CPU.

- Trees written by the port's `data/synth.py` (the raytraced scene):
  LLFF in eval modes mvsnerf and gpnr, Blender in mvsnerf and gpnr with
  a real alpha (blended onto white), T&T in mvsnerf with nf_mode minmax
  and its JPEGs larger than img_wh (the intrinsics scaled by the file's
  size).
- Trees of random poses and random images, the port's own copies of the
  tree-writing helpers of tests/test_datasets_synthetic.py and tests/test_datasets.py:
  LLFF gpnr, Blender mvsnerf with random RGBA, T&T mvsnerf.
- Every key of every sample: images, intrinsics, extrinsics, near/fars,
  view_ids, img_wh and c2ws_all with the same dtype and shape, equal, the
  float poses within 1e-6.
- The helpers under them: `average_poses` / `center_poses` /
  `load_llff_poses`, the alpha blend of `load_images`, `png_size` and
  `image_size` against PIL.
"""
import json
import os

import numpy as np
import pytest

import matchnerf_tpu.data as jdata
from matchnerf_tpu.data import common as jcommon
from matchnerf_tpu_torch.data import DATASETS, common, synth
from matchnerf_tpu_torch.data.png import png_size, write_png

POSE_KEYS = ("extrinsics", "intrinsics", "near_fars", "c2ws_all")


def _assert_samples_equal(a, b, tag):
    assert sorted(a) == sorted(b), tag
    assert a["scene"] == b["scene"], tag
    for k in a:
        if k == "scene":
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (tag, k, x.dtype, y.dtype)
        if k in POSE_KEYS:
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=0, err_msg=f"{tag} {k}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{tag} {k}")


def _assert_loaders_equal(name, root, tag, **kw):
    mine = DATASETS[name](str(root), "test", **kw)
    theirs = jdata.datas_dict[name](str(root), "test", **kw)
    assert len(mine) == len(theirs) > 0 and mine.get_name() == theirs.get_name() == name
    for i in range(len(mine)):
        _assert_samples_equal(mine[i], theirs[i], f"{tag}[{i}]")
    return mine


# ---- trees of the port's synthetic scene -----------------------------------

@pytest.mark.parametrize("eval_mode", ["mvsnerf", "gpnr"])
def test_llff_synth_tree(tmp_path, eval_mode):
    synth.write_llff_tree(str(tmp_path / "llff"), str(tmp_path / "meta"), 64, 32,
                          n_views=10, test_views=(3, 7))
    ds = _assert_loaders_equal("llff", tmp_path / "llff", f"llff {eval_mode}", n_views=3,
                               img_wh=(64, 32), eval_mode=eval_mode,
                               meta_dir=str(tmp_path / "meta"))
    # mvsnerf: the pairs' 2 targets; gpnr: every 8th of 10 images
    assert [m[1] for m in ds.metas] == ([3, 7] if eval_mode == "mvsnerf" else [0, 8])
    assert ds[0]["c2ws_all"].shape == (8, 4, 4)


@pytest.mark.parametrize("eval_mode", ["mvsnerf", "gpnr"])
def test_blender_synth_tree(tmp_path, eval_mode):
    synth.write_blender_tree(str(tmp_path / "nerf_synthetic"), str(tmp_path / "meta"), 64, 32,
                             n_train=4, n_test=2)
    ds = _assert_loaders_equal("blender", tmp_path / "nerf_synthetic",
                               f"blender {eval_mode}", n_views=3, img_wh=(64, 32),
                               eval_mode=eval_mode, meta_dir=str(tmp_path / "meta"))
    sample = ds[0]
    assert sample["view_ids"].dtype.kind == "i" and sample["view_ids"][-1] in (0, 4)
    np.testing.assert_array_equal(sample["near_fars"], np.tile([2.0, 6.0], (4, 1)))
    # the alpha is real: some pixels fully transparent, some partly
    from matchnerf_tpu_torch.data.png import read_png
    a = read_png(str(tmp_path / "nerf_synthetic" / "lego" / "train" / "r_0.png"))[..., 3]
    assert (a == 0).any() and (a == 255).any() and ((a > 0) & (a < 255)).any()


def test_tnt_synth_tree(tmp_path):
    pytest.importorskip("PIL")
    synth.write_tnt_tree(str(tmp_path / "tnt"), str(tmp_path / "meta"), 80, 48, n_views=6)
    ds = _assert_loaders_equal("tnt", tmp_path / "tnt", "tnt", n_views=3, img_wh=(64, 32),
                               nf_mode="minmax", meta_dir=str(tmp_path / "meta"))
    # intrinsics scaled by img_wh over the JPEG's 80x48
    intr = ds[0]["intrinsics"][0]
    assert intr[0, 2] == pytest.approx(32.0) and intr[1, 2] == pytest.approx(16.0)


# ---- random trees (copies of the JAX package's test tree writers) ----------

def _write_mvsnet_cam(path, extr, intr, d0, d1):
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in extr:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in intr:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        f.write(f"\n{d0} {d1}\n")


def _rand_extr(rng):
    from scipy.spatial.transform import Rotation
    e = np.eye(4, dtype=np.float64)
    e[:3, :3] = Rotation.random(random_state=rng).as_matrix()
    e[:3, 3] = rng.standard_normal(3)
    return e


def _save_img(path, rng, h=48, w=64):
    from PIL import Image
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path)


def _pairs(path, pairs):
    import torch
    torch.save(pairs, str(path / "pairs.th"))


def _random_llff(tmp_path):
    rng = np.random.default_rng(2)
    scene_dir = tmp_path / "fern"
    os.makedirs(scene_dir / "images")
    n = 10
    poses = np.zeros((n, 3, 5))
    for i in range(n):
        poses[i, :, :4] = _rand_extr(rng)[:3]
        poses[i, :, 4] = [48, 64, 80.0]
        _save_img(scene_dir / "images" / f"img_{i:03d}.png", rng)
    bounds = np.sort(rng.uniform(2.0, 8.0, (n, 2)), axis=1)
    np.save(scene_dir / "poses_bounds.npy", np.concatenate([poses.reshape(n, 15), bounds], 1))
    return "llff", dict(eval_mode="gpnr", scene_list=["fern"], img_wh=(64, 48))


def _random_blender(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    scene = "lego"
    os.makedirs(tmp_path / scene / "train")
    frames = []
    for i in range(6):
        c2w = np.eye(4)
        c2w[:3, 3] = rng.standard_normal(3)
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
        Image.fromarray(rng.integers(0, 255, (32, 32, 4), dtype=np.uint8), "RGBA").save(
            tmp_path / scene / "train" / f"r_{i}.png")
    with open(tmp_path / scene / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    _pairs(tmp_path, {f"{scene}_train": [0, 1, 2, 3], f"{scene}_val": [4, 5]})
    return "blender", dict(scene_list=[scene], meta_dir=str(tmp_path), img_wh=(32, 32))


def _random_tnt(tmp_path):
    rng = np.random.default_rng(0)
    scene = "Truck"
    os.makedirs(tmp_path / scene / "images")
    os.makedirs(tmp_path / scene / "cams_1")
    for i in range(6):
        intr = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
        _write_mvsnet_cam(tmp_path / scene / "cams_1" / f"{i:08d}_cam.txt", _rand_extr(rng),
                          intr, 0.5, 0.05)
        _save_img(tmp_path / scene / "images" / f"{i:08d}.jpg", rng)
    _pairs(tmp_path, {f"TNT_{scene}_train": [0, 1, 2, 3], f"TNT_{scene}_val": [4, 5]})
    return "tnt", dict(scene_list=[scene], meta_dir=str(tmp_path), nf_mode="minmax",
                       img_wh=(32, 32))


@pytest.mark.parametrize("build", [_random_llff, _random_blender, _random_tnt],
                         ids=["llff_gpnr", "blender_mvsnerf", "tnt_mvsnerf"])
def test_random_trees(tmp_path, build):
    pytest.importorskip("PIL")
    name, kw = build(tmp_path)
    _assert_loaders_equal(name, tmp_path, f"random {name}", n_views=3, **kw)


# ---- helpers -----------------------------------------------------------------

def test_llff_pose_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    poses = np.stack([_rand_extr(rng)[:3] for _ in range(6)])
    np.testing.assert_array_equal(common.average_poses(poses), jcommon.average_poses(poses))
    np.testing.assert_array_equal(common.center_poses(poses), jcommon.center_poses(poses))
    raw = np.concatenate([poses, np.tile([[48.0], [64.0], [80.0]], (6, 1, 1))], axis=2)
    np.save(tmp_path / "pb.npy", np.concatenate(
        [raw.reshape(6, 15), np.sort(rng.uniform(1, 9, (6, 2)), 1)], 1))
    for center, scale in ((True, 0.75), (False, 0.47058824)):
        for a, b in zip(common.load_llff_poses(str(tmp_path / "pb.npy"), center, scale),
                        jcommon.load_llff_poses(str(tmp_path / "pb.npy"), center, scale)):
            np.testing.assert_array_equal(a, b)


def test_alpha_blend_and_image_size_match_pil(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(1)
    rgba = rng.integers(0, 256, (24, 40, 4), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), rgba)
    Image.fromarray(rgba[..., :3]).save(tmp_path / "b.jpg")
    for wh in ((40, 24), (32, 32)):            # no resize, and PIL's resize
        got = common.load_image(str(tmp_path / "a.png"), wh, blend_alpha_white=True)
        want = jcommon.load_image(str(tmp_path / "a.png"), wh, blend_alpha_white=True)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert png_size(str(tmp_path / "a.png")) == (40, 24)
    for name in ("a.png", "b.jpg"):
        with Image.open(tmp_path / name) as im:
            assert common.image_size(str(tmp_path / name)) == im.size
