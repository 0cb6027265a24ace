"""The eval slice end to end: the PyTorch port's `Renderer.forward(mode=
"test")` vs the JAX `Renderer.forward(mode="test")` on the CPU, from the
same JAX PRNG(0) weights and the same numpy scene.

(a) the slice's kernel settings (banded_kernel, decoder_kernel, no
    block_kernel) with f32 tables, so the JAX banded and decoder Pallas
    kernels run in interpret mode;
(b) int8 feature and uint8 colour tables, against the JAX direct path.

Both use the f32 encoder (a bf16 encoder rounds at other places in the two
frameworks). Required agreement: PSNR >= 60 dB on rgb, the repo's budget
for reassociation. Also: the config dict that chip_smoke.py renders with
equals configs/test.yaml (block_kernel off) on every key the slice reads,
and the port imports without jax, yaml or PIL.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.renderer import Renderer as JaxRenderer
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.config import SLICE_KEYS, dtu_eval_slice_config
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF
from matchnerf_tpu_torch.renderer import Renderer
from matchnerf_tpu_torch.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 32


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def _setup(precision):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=2, sample_intvs=48)))
    cfg.precision = DotDict(precision)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    d = ge._synthetic_inputs(cfg, 1, H, W, R=16)
    batch = {"images": d["images"], "extrinsics": d["poses"],
             "intrinsics": d["intr"], "near_fars": d["near_fars"]}
    return cfg, params, model, batch


SLICE_F32 = {"encoder_compute_dtype": "float32", "cond_sample_dtype": "float32",
             "color_sample_dtype": "float32", "banded_kernel": True,
             "block_kernel": False, "decoder_kernel": True}
SLICE_INT8 = dict(SLICE_F32, cond_sample_dtype="int8", color_sample_dtype="uint8")
JAX_DIRECT_INT8 = dict(SLICE_INT8, banded_kernel=False, decoder_kernel=False)


@pytest.mark.parametrize("case", ["a_kernels_f32_tables", "b_int8_vs_direct"])
def test_render_matches_jax(case):
    port_prec = SLICE_F32 if case.startswith("a") else SLICE_INT8
    jax_prec = SLICE_F32 if case.startswith("a") else JAX_DIRECT_INT8
    cfg, params, model, batch = _setup(port_prec)
    jcfg = DotDict(dict(cfg))
    jcfg.precision = DotDict(jax_prec)
    jr = JaxRenderer(jcfg)
    if case.startswith("a"):
        # the JAX side must take its banded Pallas kernel (a kt bucket per scale)
        feats = jr.encode(params, jax.numpy.asarray(batch["images"][:, :3]))
        tables = jr.build_tables(jax.numpy.asarray(batch["images"][:, :3]), feats)
        from matchnerf_tpu.renderer import extract_poses as jax_poses
        poses = jax_poses(batch)
        assert jr._banded_kt(poses, poses["tgt"], tables, H, W) is not None
    ref = jr.forward(params, batch, mode="test")
    out = Renderer(cfg, model, "cpu").forward(batch, mode="test")
    for k in ("rgb", "depth", "opacity"):
        assert tuple(out[k].shape) == ref[k].shape
        assert torch.isfinite(out[k]).all()
    psnr = _psnr(out["rgb"].numpy(), ref["rgb"])
    assert psnr >= 60.0, f"agreement PSNR {psnr:.1f} dB < 60"
    assert float(ref["opacity"].max()) > 0.01      # the scene is not empty


def test_chip_smoke_config_matches_yaml():
    from matchnerf_tpu.config import load_options
    opt = load_options(os.path.join(REPO, "configs", "test.yaml"))
    opt.precision.block_kernel = False
    mine = dtu_eval_slice_config()
    for key in SLICE_KEYS:
        a, b = opt, mine
        for part in key.split("."):
            a, b = a[part], b[part]
        assert a == b, f"{key}: yaml {a!r} vs dict {b!r}"
    assert "max_rays_per_slice" not in opt.nerf and "max_rays_per_slice" not in mine.nerf


def test_port_imports_without_jax_yaml_pil():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'yaml', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import matchnerf_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'matchnerf_tpu_torch.renderer' in names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'yaml', 'PIL')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20
