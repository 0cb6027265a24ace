"""The golden presets through the port end to end at f32 encoder
precision, against the JAX package's render of the same config: see
tests/test_torch_golden_images.py, which holds the presets to the goldens
and whose helpers this file shares."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from golden_common import PRESETS, golden_cfg
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.renderer import Renderer as JaxRenderer
from test_torch_golden_images import port_net, port_render, preset_batch
from torch_threads import one_torch_thread  # noqa: F401

# the JAX renderer's Pallas routes; off, it computes their functions in XLA
JAX_KERNELS = ("banded_kernel", "block_kernel", "decoder_kernel", "color_block_kernel")


@pytest.fixture(scope="module")
def params():
    return jax_init(jax.random.PRNGKey(0), golden_cfg())


@pytest.mark.parametrize("name,H,W,setbg", PRESETS, ids=[p[0] for p in PRESETS])
def test_port_f32_render_matches_jax(params, name, H, W, setbg):
    jcfg = golden_cfg()
    jcfg.precision.encoder_compute_dtype = "float32"
    for k in JAX_KERNELS:
        setattr(jcfg.precision, k, False)
    batch = preset_batch(H, W)
    jout = JaxRenderer(jcfg, setbg_opaque=setbg).forward(
        params, {k: jnp.asarray(x) for k, x in batch.items()}, mode="test")
    want = np.asarray(jout["rgb"][0], np.float32)
    cfg, net = port_net(jcfg, params, "float32")
    rgb, depth = port_render(cfg, net, batch, setbg)
    assert rgb.shape == want.shape == (H * W, 3)
    psnr = -10.0 * np.log10(max(float(np.mean((rgb.astype(np.float64) - want) ** 2)), 1e-20))
    assert psnr >= 80.0, f"{name}: the port's f32-encoder render vs JAX's {psnr:.2f} dB < 80"
    assert np.all(np.isfinite(rgb)) and float(depth.min()) > 0.0
