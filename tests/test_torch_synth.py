"""The port's copy of the numpy scene raytracer gives bit-identical views to
the JAX package's (chip_smoke.py renders its scene with the port's copy)."""
import numpy as np
import pytest

from matchnerf_tpu.data import synth as jax_synth
from matchnerf_tpu_torch.data import synth


@pytest.mark.parametrize("eyes", [None, [(1.0, -1.0, -3.5), (-0.4, -1.2, -3.7)]])
def test_make_scene_views_bit_identical(eyes):
    kw = dict(focal=40.0, eyes=eyes) if eyes is not None else {}
    got = synth.make_scene_views(48, 40, **kw)
    want = jax_synth.make_scene_views(48, 40, **kw)
    assert set(got) == set(want)
    for k in ("images", "w2cs", "intrinsics", "c2ws", "near_fars", "depths"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _dtu_tree_files(root):
    import os
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _camera_angles(root, view_ids):
    """Each view's angle on the arc (degrees) from its camera file's centre."""
    import os
    angles = []
    for vid in view_ids:
        with open(os.path.join(root, "DTU", "Cameras", "train", f"{vid:08d}_cam.txt")) as f:
            rows = f.read().split("\n")[1:5]
        extr = np.array([[float(v) for v in r.split()] for r in rows])
        centre = -extr[:3, :3].T @ extr[:3, 3] / 200.0
        angles.append(np.degrees(np.arctan2(centre[0], -centre[2])))
    return np.array(angles)


def test_write_dtu_scene_spread(tmp_path):
    """`spread` scales the arc's angles: 1.0 writes the default tree byte for
    byte, 0.5 puts every camera at half its default angle."""
    kw = dict(W=64, H=64, n_views=9)
    trees = {}
    for name, extra in (("default", {}), ("one", {"spread": 1.0}), ("half", {"spread": 0.5})):
        synth.write_dtu_scene(str(tmp_path / name / "DTU"), str(tmp_path / name / "meta"),
                              **kw, **extra)
        trees[name] = _dtu_tree_files(tmp_path / name)
    assert trees["one"] == trees["default"]
    ids = synth.dtu_scene_view_ids(9)
    full = _camera_angles(tmp_path / "default", ids)
    half = _camera_angles(tmp_path / "half", ids)
    np.testing.assert_allclose(full, synth._DTU_SCENE_ANGLES[:9], atol=1e-6)
    np.testing.assert_allclose(half, 0.5 * full, atol=1e-6)
