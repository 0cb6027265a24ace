"""The golden presets through the port: each preset of tests/golden_common.py
(dtu 48x64, llff 48x96, blender 48x48 onto white) rendered by the port's
`Renderer.forward(mode="test")` with configs/test.yaml (int8 / uint8
tables, the block route: the plain versions of Kernels D, E and C on the
CPU) and nerf.rand_rays_test 1024, on the JAX package's PRNG(0)
parameters passed across by `weights.py`. Two cases a preset:

- `test_port_render_matches_golden`: test.yaml as shipped, held to the
  committed tests/goldens/*.png (read with the port's PNG decoder) at the
  JAX golden test's 45 dB (tests/test_golden_images.py). The port renders
  from the JAX encoder's bf16 features (`Renderer.encode` of the JAX
  package on the same images and parameters: an encode, not a render), so
  this case holds the port's tables, cond query, decoder and composite to
  the goldens.
- `test_port_f32_render_matches_jax` (tests/test_torch_golden_f32.py, a
  file of its own so that the test run spreads the two over its workers):
  the port end to end, its own encoder included, with
  precision.encoder_compute_dtype float32, against the JAX package's
  render of the same config at >= 80 dB. The JAX side takes its plain XLA
  route (banded, block, decoder and colour kernels off: the functions its
  Pallas kernels compute, without the interpret-mode cost).

Why the encoder is taken across in the first case: the bf16 encoder
rounds at other places in the two frameworks (XLA keeps f32 between fused
operations, torch rounds every operation), and the int8 tables carry that
into the image; with its own bf16 encoder the port's image lies about
45 dB from the goldens and from the JAX render, which is why the
second case holds the port's encoder at f32. `python
tests/golden_port_report.py` prints, per preset, both packages at both
encoder precisions against each other and against the goldens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_common import GOLDEN_DIR, PRESETS, golden_cfg, psnr_vs_golden
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.renderer import Renderer as JaxRenderer
from matchnerf_tpu_torch.config import CONFIGS
from matchnerf_tpu_torch.data.png import read_png
from matchnerf_tpu_torch.data.synth import make_scene_views
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF
from matchnerf_tpu_torch.renderer import Renderer
from matchnerf_tpu_torch.weights import state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401


def port_net(jcfg, params, encoder_dtype=None):
    """(the port's test.yaml config as the goldens use it, the model with
    the JAX PRNG(0) parameters)."""
    cfg = CONFIGS["test"]()
    cfg.nerf.rand_rays_test = jcfg.nerf.rand_rays_test
    cfg.load = None
    if encoder_dtype:
        cfg.precision.encoder_compute_dtype = encoder_dtype
    net = MatchNeRF(cfg)
    net.load_state_dict(state_dict_from_jax(params), strict=True)
    return cfg, net.eval()


def preset_batch(H, W):
    v = make_scene_views(W, H)
    return {"images": v["images"][None], "extrinsics": v["w2cs"][None],
            "intrinsics": v["intrinsics"][None], "near_fars": v["near_fars"][None]}


def port_render(cfg, net, batch, setbg, encode=None):
    renderer = Renderer(cfg, net, "cpu")
    renderer.setbg_opaque = setbg
    if encode is not None:
        renderer.encode = encode
    with torch.no_grad():
        out = renderer.forward(batch, mode="test")
    return out["rgb"][0].float().numpy(), out["depth"][0].float().numpy()


@pytest.fixture(scope="module")
def models():
    jcfg = golden_cfg()
    params = jax_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, port_net(jcfg, params)


@pytest.mark.parametrize("name,H,W,setbg", PRESETS, ids=[p[0] for p in PRESETS])
def test_port_render_matches_golden(models, name, H, W, setbg):
    jcfg, params, (cfg, net) = models
    golden = read_png(f"{GOLDEN_DIR}/{name}.png")
    batch = preset_batch(H, W)
    feats = JaxRenderer(jcfg).encode(params, jnp.asarray(batch["images"][:, :cfg.n_src_views]))
    rgb, depth = port_render(cfg, net, batch, setbg, lambda ref_images: [
        torch.from_numpy(np.asarray(f, np.float32)) for f in feats])
    img = np.round(np.clip(rgb.reshape(H, W, 3), 0.0, 1.0) * 255.0).astype(np.uint8)
    assert img.shape == golden.shape == (H, W, 3)
    psnr = psnr_vs_golden(img, golden)
    assert psnr >= 45.0, f"{name}: the port's render vs the committed golden {psnr:.1f} dB < 45"
    assert float(depth.min()) > 0.0
