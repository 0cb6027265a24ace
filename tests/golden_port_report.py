"""Per golden preset, the port's render against the JAX package's and
against the committed golden, at both encoder precisions, on the CPU:

    python tests/golden_port_report.py

For each preset of tests/golden_common.py and each of
precision.encoder_compute_dtype bfloat16 (configs/test.yaml as shipped)
and float32, it renders test.yaml on the JAX PRNG(0) parameters with the
port end to end (its own encoder, the plain versions of its kernels) and
with the JAX package, both through its Pallas kernels (interpret mode,
the goldens' route) and through its plain XLA route, and prints the PSNR
of the port's float image against each, and of each uint8 image against
the golden. It takes a few minutes; tests/test_torch_golden_images.py and
tests/test_torch_golden_f32.py hold the cases that the test run checks.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from golden_common import GOLDEN_DIR, PRESETS, golden_cfg, psnr_vs_golden  # noqa: E402
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init  # noqa: E402
from matchnerf_tpu.renderer import Renderer as JaxRenderer  # noqa: E402
from matchnerf_tpu_torch.data.png import read_png  # noqa: E402
from test_torch_golden_f32 import JAX_KERNELS  # noqa: E402
from test_torch_golden_images import port_net, port_render, preset_batch  # noqa: E402


def psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return -10.0 * np.log10(max(float(np.mean(d ** 2)), 1e-20))


def u8(rgb, H, W):
    return np.round(np.clip(rgb.reshape(H, W, 3), 0.0, 1.0) * 255.0).astype(np.uint8)


def main():
    import torch
    torch.set_num_threads(1)
    params = jax_init(jax.random.PRNGKey(0), golden_cfg())
    for name, H, W, setbg in PRESETS:
        golden = read_png(f"{GOLDEN_DIR}/{name}.png")
        batch = preset_batch(H, W)
        for enc in ("bfloat16", "float32"):
            cfg, net = port_net(golden_cfg(), params, enc)
            port, _ = port_render(cfg, net, batch, setbg)
            line = [f"{name} encoder {enc}: port vs golden {psnr_vs_golden(u8(port, H, W), golden):.2f} dB"]
            for route in ("kernels", "plain"):
                jcfg = golden_cfg()
                jcfg.precision.encoder_compute_dtype = enc
                if route == "plain":
                    for k in JAX_KERNELS:
                        setattr(jcfg.precision, k, False)
                out = JaxRenderer(jcfg, setbg_opaque=setbg).forward(
                    params, {k: jnp.asarray(x) for k, x in batch.items()}, mode="test")
                ref = np.asarray(out["rgb"][0], np.float32)
                line.append(f"JAX {route} vs golden "
                            f"{psnr_vs_golden(u8(ref, H, W), golden):.2f} dB, port vs JAX {route} "
                            f"{psnr(port, ref):.2f} dB (max |d| {np.abs(port - ref).max():.2e})")
            print("; ".join(line), flush=True)


if __name__ == "__main__":
    main()
