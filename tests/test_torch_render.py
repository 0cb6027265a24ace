"""The eval slice end to end: the PyTorch port's `Renderer.forward(mode=
"test")` vs the JAX `Renderer.forward(mode="test")` on the CPU, from the
same JAX PRNG(0) weights and the same numpy scene.

(a) the slice's kernel settings (banded_kernel, decoder_kernel, no
    block_kernel) with f32 tables, so the JAX banded and decoder Pallas
    kernels run in interpret mode;
(b) int8 feature and uint8 colour tables, against the JAX direct path;
(c) the precision of configs/test.yaml as shipped (block_kernel and
    color_block_kernel on: Kernels D and E, their plain versions here),
    against the JAX block-path render (its block and supercell Pallas
    kernels in interpret mode) and against the JAX direct int8 path.

All use the f32 encoder (a bf16 encoder rounds at other places in the two
frameworks). Required agreement: PSNR >= 60 dB on rgb, the repo's budget
for reassociation. Also: the port's per-pose route (`Renderer.pose_prep`)
equals the JAX `_pose_prep`'s, an overflowing union falls back to Kernel B
and the colour gather without changing the image (>= 90 dB: the same
function by another route), the config dicts equal configs/test.yaml, and
the port imports nothing of jax, yaml, PIL or the JAX package.
"""
import json
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
from matchnerf_tpu_torch.config import (SLICE_KEYS, dtu_eval_config,
                                       dtu_eval_per_ray_config, dtu_train_config,
                                       dtu_train_fast_config)
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
# configs/test.yaml's precision as shipped, with the f32 encoder
SHIPPED = dict(dtu_eval_config().precision, encoder_compute_dtype="float32")


def _scale_hws(tables):
    return [(v.shape[2], v.shape[3]) for v in tables["view_feats"]]


def _jax_tables(jr, params, batch):
    from matchnerf_tpu.renderer import extract_poses as jax_poses
    imgs = jax.numpy.asarray(batch["images"][:, :3])
    tables = jr.build_tables(imgs, jr.encode(params, imgs))
    return jax_poses(batch), tables


@pytest.mark.parametrize("case", ["a_kernels_f32_tables", "b_int8_vs_direct",
                                  "c_shipped_block_path"])
def test_render_matches_jax(case):
    if case.startswith("c"):
        cfg, params, model, batch = _setup(SHIPPED)
        jr = JaxRenderer(cfg)
        # the JAX side must take its block and supercell kernels
        poses, tables = _jax_tables(jr, params, batch)
        _, block_ut, color_ut = jr._pose_prep(poses, poses["tgt"], _scale_hws(tables),
                                              H, W, measure_color=True)
        assert block_ut is not None and color_ut is not None
        renderer = Renderer(cfg, model, "cpu")
        out = renderer.forward(batch, mode="test")
        assert renderer.last_route == {"block_ut": block_ut, "color_ut": color_ut}
        jcfg = DotDict(dict(cfg))
        jcfg.precision = DotDict(JAX_DIRECT_INT8)
        for ref in (jr.forward(params, batch, mode="test"),
                    JaxRenderer(jcfg).forward(params, batch, mode="test")):
            psnr = _psnr(out["rgb"].numpy(), ref["rgb"])
            assert psnr >= 60.0, f"agreement PSNR {psnr:.1f} dB < 60"
        return
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


def test_pose_prep_matches_jax():
    cfg, params, model, batch = _setup(SHIPPED)
    jr = JaxRenderer(cfg)
    poses, tables = _jax_tables(jr, params, batch)
    want = jr._pose_prep(poses, poses["tgt"], _scale_hws(tables), H, W,
                         measure_color=True)[1:]
    from matchnerf_tpu_torch.renderer import extract_poses
    got = Renderer(cfg, model, "cpu").pose_prep(extract_poses(batch), _scale_hws(tables),
                                                H, W, measure_color=True)
    assert got == want == ((64, 64), 48)


def test_overflowing_union_falls_back(monkeypatch):
    """Buckets patched below the measured unions (9 and 14 rows at the two
    scales, 8 supercells): scale 1 and the colours overflow and take Kernel
    B's plain version and the colour gather, scale 0 keeps Kernel D."""
    import matchnerf_tpu_torch.models.matchnerf as mm
    from matchnerf_tpu_torch.ops import block_cosine_prior as kd
    from matchnerf_tpu_torch.ops import supercell_color as ke
    cfg, params, model, batch = _setup(SHIPPED)
    base = Renderer(cfg, model, "cpu")
    ref = base.forward(batch, mode="test")
    assert base.last_route == {"block_ut": (64, 64), "color_ut": 48}

    calls = []
    for name in ("cosine_prior", "block_cosine_prior", "supercell_color_sample"):
        fn = getattr(mm, name)
        monkeypatch.setattr(mm, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    monkeypatch.setattr(kd, "UT_BUCKETS", (10,))
    monkeypatch.setattr(ke, "COLOR_UT_BUCKETS", (4,))
    patched = Renderer(cfg, model, "cpu")
    out = patched.forward(batch, mode="test")
    assert patched.last_route == {"block_ut": (10, None), "color_ut": None}
    n_slices = H * W // int(cfg.nerf.rand_rays_test)
    assert sorted(calls) == sorted(["cosine_prior", "block_cosine_prior"] * n_slices)
    psnr = _psnr(out["rgb"].numpy(), ref["rgb"].numpy())
    assert psnr >= 90.0, f"fallback changed the image: {psnr:.1f} dB"


def _port_setup(precision):
    """The tiny config with seeded port weights (no JAX weights needed)."""
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=16)))
    cfg.precision = DotDict(precision)
    model = init_matchnerf(cfg, torch.Generator().manual_seed(0))
    d = ge._synthetic_inputs(cfg, 1, H, W, R=16)
    batch = {"images": d["images"], "extrinsics": d["poses"],
             "intrinsics": d["intr"], "near_fars": d["near_fars"]}
    return cfg, model, batch


_JAX_BF16 = {}


def _jax_bf16_render(value):
    """The JAX renderer with precision.decoder_matmul_dtype = value (its
    Pallas decoder with matmul_dtype=bfloat16, interpret mode), and the
    same render with float32, once per value."""
    if value not in _JAX_BF16:
        cfg, params, model, batch = _setup(dict(SLICE_F32, decoder_matmul_dtype=value))
        f32 = DotDict(dict(cfg))
        f32.precision = DotDict(SLICE_F32)
        _JAX_BF16[value] = (cfg, model, batch,
                            JaxRenderer(cfg).forward(params, batch, mode="test"),
                            JaxRenderer(f32).forward(params, batch, mode="test"))
    return _JAX_BF16[value]


@pytest.mark.parametrize("value,kernel", [("bf16", True), ("bfloat16", True),
                                          ("bf16", False)])
def test_decoder_matmul_dtype_bf16_matches_jax(value, kernel):
    """precision.decoder_matmul_dtype: bf16 on the eval decoder route renders
    the JAX renderer's image with the same key at >= 60 dB, through the
    kernel wrapper (Kernel C's bf16 route; its plain twin on the CPU) and in
    the all-plain reference, and is closer to it than to the f32 image."""
    cfg, model, batch, ref, ref_f32 = _jax_bf16_render(value)
    out = Renderer(cfg, model, "cpu", kernel=kernel).forward(batch, mode="test")
    for k in ("rgb", "depth", "opacity"):
        assert tuple(out[k].shape) == ref[k].shape and torch.isfinite(out[k]).all()
    psnr = _psnr(out["rgb"].numpy(), ref["rgb"])
    assert psnr >= 60.0, f"agreement PSNR {psnr:.1f} dB < 60"
    assert psnr > _psnr(out["rgb"].numpy(), ref_f32["rgb"]) + 10.0
    assert float(ref["opacity"].max()) > 0.01


def test_decoder_matmul_dtype_float32_renders_as_before():
    """float32 renders the image the absent key renders; under
    precision.strict the key reads float32 and the render goes through."""
    cfg, model, batch = _port_setup(SLICE_F32)
    ref = Renderer(cfg, model, "cpu").forward(batch, mode="test")
    cfg.precision = DotDict(dict(SLICE_F32, decoder_matmul_dtype="float32"))
    out = Renderer(cfg, model, "cpu").forward(batch, mode="test")
    for k in ("rgb", "depth", "opacity"):
        torch.testing.assert_close(out[k], ref[k], atol=0, rtol=0)
    cfg.precision = DotDict(dict(SLICE_F32, decoder_matmul_dtype="bf16", strict=True))
    out = Renderer(cfg, model, "cpu").forward(batch, mode="test")
    assert all(bool(torch.isfinite(out[k]).all()) for k in ("rgb", "depth", "opacity"))


def test_batched_block_path_splits_per_pose():
    """B = 2 on the block path renders each pose on its own (no supercell
    table at B > 1, as in the JAX package): each element equals a B = 1
    render of that pose."""
    import __graft_entry__ as ge2
    cfg, params, model, _ = _setup(SHIPPED)
    d = ge2._synthetic_inputs(cfg, 2, H, W, R=16)
    batch = {"images": d["images"], "extrinsics": d["poses"],
             "intrinsics": d["intr"], "near_fars": d["near_fars"]}
    renderer = Renderer(cfg, model, "cpu")
    out = renderer.forward(batch, mode="test")
    assert renderer.last_route["block_ut"] is not None
    assert renderer.last_route["color_ut"] is None
    for b in range(2):
        one = Renderer(cfg, model, "cpu").forward(
            {k: v[b:b + 1] for k, v in batch.items()}, mode="test")
        for k in ("rgb", "depth", "opacity"):
            np.testing.assert_allclose(out[k][b].numpy(), one[k][0].numpy(),
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["shipped", "per_ray", "train", "train_fast"])
def test_chip_smoke_config_matches_yaml(variant):
    from matchnerf_tpu.config import load_options
    if variant.startswith("train"):
        # every key of the YAML files (the command line sets `yaml`)
        opt = load_options(os.path.join(REPO, "configs", f"{variant}.yaml"))
        mine = dtu_train_config() if variant == "train" else dtu_train_fast_config()
        assert mine.pop("yaml") == variant and opt.pop("yaml") is None
        assert json.loads(json.dumps(mine)) == json.loads(json.dumps(opt))
        assert bool(mine.nerf.get("train_ray_patches")) == (variant == "train_fast")
        return
    opt = load_options(os.path.join(REPO, "configs", "test.yaml"))
    if variant == "per_ray":
        opt.precision.block_kernel = False
        mine = dtu_eval_per_ray_config()
    else:
        mine = dtu_eval_config()
    for key in SLICE_KEYS:
        a, b = opt, mine
        for part in key.split("."):       # absent on both sides reads as the default
            a, b = a.get(part), b.get(part)
        assert a == b, f"{key}: yaml {a!r} vs dict {b!r}"
    assert "max_rays_per_slice" not in opt.nerf and "max_rays_per_slice" not in mine.nerf


def test_port_imports_without_jax_yaml_pil():
    """Every module of the port (the training step and engine included)
    imports with jax, yaml, PIL and the JAX package blocked, and
    chip_smoke.py names no file or module of the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'yaml', 'PIL', 'matchnerf_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import matchnerf_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for m in ('renderer', 'train_step', 'engine', 'score_preds', 'data.llff',\n"
        "          'data.blender', 'data.tnt'):\n"
        "    assert 'matchnerf_tpu_torch.' + m in names, m\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'yaml', 'PIL', 'matchnerf_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 29
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        smoke = f.read()
    assert "matchnerf_tpu/" not in smoke and "matchnerf_tpu." not in smoke
    assert "import jax" not in smoke and "from jax" not in smoke
