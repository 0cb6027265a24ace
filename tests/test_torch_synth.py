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
