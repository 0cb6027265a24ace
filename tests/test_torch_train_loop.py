"""The training loop of the port (configs/train.yaml's `train_model`) on the
CPU, against the JAX package where it has a counterpart.

- `CONFIGS["train"]` and `CONFIGS["train_fast"]` equal the JAX package's
  resolved configs/train.yaml and configs/train_fast.yaml (`build_options`,
  as train.py calls it) on every key.
- `train_model` on a tiny config: the iteration count, checkpoint names
  (`latest.ckpt`, `ep1_it2.ckpt`, `ep2_it4.ckpt`), validation images, test
  results and scalars that tests/test_train_flow.py asserts for the JAX
  package; the hook schedule (`ceil(freq.x_it * len(loader))`).
- resume: `epoch_start` / `iter_start`, the model and AdamW state bit-equal
  to the checkpoint's, and the mid-epoch fast-forward (batches before the
  restored iteration are skipped).
- the preemption handler: SIGTERM between steps or inside one writes
  `latest.ckpt` at the last finished step and exits with 143.
- the depth colouring of the validation images: the port's JET table
  equals cv2's `COLORMAP_JET` and `visualize_depth` the JAX package's.
- `validate_model` on bf16 tables through the block route (the eval path of
  configs/train.yaml): the image >= 60 dB against the JAX `validate_model`
  render of the same weights and batch, the same per-scale route, and the
  same PSNR in scalars.jsonl.
"""
import copy
import json
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu import config as jconfig
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.utils import DotDict as JDotDict
from matchnerf_tpu.utils import to_plain_dict
from matchnerf_tpu_torch.config import CONFIGS, override_options
from matchnerf_tpu_torch.data.loader import DataLoader
from matchnerf_tpu_torch.engine import Coach
from matchnerf_tpu_torch.utils.checkpoint import load_checkpoint
from matchnerf_tpu_torch.weights import state_dict_from_jax

H = W = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tiny models: their many small ops each
    open a parallel region, and on a host loaded by the other test workers
    every region waits for descheduled threads (a loop step 30x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["train", "train_fast"])
def test_config_matches_yaml(name):
    want = to_plain_dict(jconfig.build_options(JDotDict(yaml=name)))
    got = json.loads(json.dumps(CONFIGS[name]()))
    assert got == want


class SyntheticDataset:
    """Random posed scenes of the sample contract (the JAX package's
    tests/test_engine.py dataset, made by __graft_entry__)."""

    def __init__(self, n, with_depth=False):
        self.n, self.with_depth, self.max_len = n, with_depth, -1

    def get_name(self):
        return "synthetic"

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        d = ge._synthetic_inputs(ge._tiny_cfg(), 1, H, W, R=16, seed=i)
        ext = np.repeat(np.eye(4, dtype=np.float32)[None], 4, 0)
        ext[:, :3] = d["poses"][0]
        sample = {"images": d["images"][0], "extrinsics": ext,
                  "intrinsics": d["intr"][0], "near_fars": d["near_fars"][0],
                  "view_ids": np.arange(4), "scene": f"scene{i}",
                  "img_wh": np.array([W, H])}
        if self.with_depth:
            sample["depth"] = np.random.default_rng(i).uniform(0, 3, (H, W)) \
                .astype(np.float32).round()
        return sample


def _tiny_train_cfg(tmp_path, **freq):
    """configs/train.yaml cut to a tiny model and image: 1 transformer layer,
    S = 16, 64 training rays, 512-ray eval slices, f32 encoder and decoder
    (bf16 rounds at other places in the two frameworks); the eval renders
    keep train.yaml's bf16 tables, uint8 colours and kernels."""
    cfg = CONFIGS["train"]()
    override_options(cfg, {
        "name": "tiny", "output_root": str(tmp_path), "max_epoch": 2,
        "sanity_check": True, "tb": False,
        "encoder": {"num_transformer_layers": 1, "pretrain_weight": None},
        "nerf": {"sample_intvs": 16, "rand_rays_train": 64, "rand_rays_val": 512,
                 "rand_rays_test": 512},
        "data_train": {"img_wh": [W, H]},
        "precision": {"encoder_compute_dtype": "float32", "decoder_compute_dtype": "float32"},
        "freq": dict(dict(scalar=1, log_ep=1, ckpt_ep=1, ckpt_it=-1, val_ep=1, val_it=-1,
                          test_ep=1, test_ep_start=0, test_it=-1), **freq),
    })
    return cfg


def _coach(cfg, n_train=2):
    coach = Coach(cfg, device="cpu")
    coach.train_loader = DataLoader(SyntheticDataset(n_train), 1, shuffle=True)
    coach.val_loader = DataLoader(SyntheticDataset(1), 1)
    coach.test_loaders = [DataLoader(SyntheticDataset(1), 1)]
    coach.build_networks()
    coach.setup_optimizer()
    coach.restore_checkpoint_if_needed()
    coach.setup_visualizer()
    return coach


def _state(coach):
    return ({k: v.detach().clone() for k, v in coach.model.state_dict().items()},
            copy.deepcopy(coach.opt.state_dict()))


def _assert_state_equal(a, b):
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    sa, sb = a[1]["adamw"]["state"], b[1]["adamw"]["state"]
    assert sa.keys() == sb.keys() and a[1]["count"] == b[1]["count"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_train_model_flow(tmp_path):
    coach = _coach(_tiny_train_cfg(tmp_path))
    coach.train_model()
    assert coach.it == 4                               # 2 epochs x 2 iterations
    mdir = os.path.join(coach.output_path, "models")
    assert sorted(os.listdir(mdir)) == ["ep1_it2.ckpt", "ep2_it4.ckpt", "latest.ckpt"]
    assert "optim" not in load_checkpoint(os.path.join(mdir, "ep1_it2.ckpt"))
    # one validation per epoch (the sanity check validates only with val_it > 0,
    # as in the JAX package; it tests at epoch 0)
    assert sorted(os.listdir(os.path.join(coach.output_path, "validation"))) == [
        "scene0_view3_it2.jpg", "scene0_view3_it4.jpg"]
    assert os.path.exists(os.path.join(coach.output_path, "test", "0results_synthetic.txt"))
    with open(coach.scalars_path) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if r["split"] == "train"] == [1, 2, 3, 4]
    assert [r["step"] for r in records if r["split"] == "val"] == [2, 4]
    assert all(np.isfinite(r["PSNR"]) and np.isfinite(r["SSIM"])
               for r in records if r["split"] == "val")
    assert [r["step"] for r in records if r["split"] == "synthetic"] == [0, 1, 2]


def test_hook_schedule_and_resume(tmp_path):
    """ceil(freq.x_it * len(loader)) periods; a mid-epoch checkpoint resumes
    with the state bit-equal and the loaded batches skipped."""
    cfg = _tiny_train_cfg(tmp_path, ckpt_ep=-1, val_ep=-1, test_ep=-1, ckpt_it=0.3,
                          val_it=0.5, scalar=0)
    cfg.sanity_check = False
    cfg.max_epoch = 1
    coach = _coach(cfg, n_train=4)
    seen = []
    coach.validate_model = lambda iteration=None, **kw: seen.append(iteration)
    saved = []
    save = coach.save_checkpoint_now
    ckpt = os.path.join(coach.output_path, "models", "latest.ckpt")

    def save_and_keep(ep, it, **kw):
        save(ep, it, **kw)
        coach.checkpoints.wait()
        shutil.copyfile(ckpt, f"{ckpt}.it{it}")
        saved.append((ep, it, _state(coach)))
    coach.save_checkpoint_now = save_and_keep
    coach.train_model()
    assert (coach.val_it, coach.ckpt_it) == (2, 2)     # ceil(0.5 * 4), ceil(0.3 * 4)
    assert seen == [2, 4] and [(e, i) for e, i, _ in saved] == [(0, 2), (0, 4)]

    # resume from the checkpoint at iteration 2 of epoch 0
    os.replace(f"{ckpt}.it2", ckpt)
    cfg2 = _tiny_train_cfg(tmp_path, ckpt_ep=-1, val_ep=-1, test_ep=-1, scalar=0)
    cfg2.update(sanity_check=False, max_epoch=1, resume=True)
    coach2 = _coach(cfg2, n_train=4)
    assert (coach2.epoch_start, coach2.iter_start) == (0, 2)
    _assert_state_equal(_state(coach2), saved[0][2])
    steps = []
    step = coach2.step
    coach2.step = lambda *a, **kw: steps.append(1) or step(*a, **kw)
    coach2.train_model()
    assert len(steps) == 2 and coach2.it == 4          # batches 0 and 1 skipped


@pytest.mark.parametrize("where", ["between_steps", "inside_step"])
def test_preemption_handler_writes_latest(tmp_path, where):
    cfg = _tiny_train_cfg(tmp_path, ckpt_ep=-1, val_ep=-1, test_ep=-1, scalar=0)
    cfg.sanity_check = False
    coach = _coach(cfg)
    batch = next(iter(coach.train_loader))
    coach.train_iteration(batch)
    previous = coach._install_preemption_handler()
    try:
        with pytest.raises(SystemExit) as exc:
            if where == "between_steps":
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                step = coach.step

                def step_then_signal(*a, **kw):
                    out = step(*a, **kw)
                    os.kill(os.getpid(), signal.SIGTERM)    # handled inside the step
                    assert coach._stop_signal == signal.SIGTERM
                    return out
                coach.step = step_then_signal
                coach.train_iteration(batch)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    assert exc.value.code == 128 + signal.SIGTERM
    ckpt = load_checkpoint(os.path.join(coach.output_path, "models", "latest.ckpt"))
    want_it = 1 if where == "between_steps" else 2
    assert ckpt["iter"] == want_it == coach.it and ckpt["optim"]["count"] == want_it
    for k, v in coach.model.state_dict().items():
        assert torch.equal(ckpt["model"][k], v), k


def test_validate_matches_jax(tmp_path, monkeypatch):
    from matchnerf_tpu import engine as jengine
    from matchnerf_tpu.ops import pallas_banded, pallas_block_banded
    from matchnerf_tpu_torch.models import matchnerf as tmn

    cfg = _tiny_train_cfg(tmp_path)
    cfg.data_val = dict(cfg.data_val, img_wh=[W, H])
    cfg.nerf.rand_rays_test = H * W                    # one slice
    jcfg = JDotDict(json.loads(json.dumps(cfg)))
    jcfg.output_path = str(tmp_path / "jax")
    jcfg.parallel = JDotDict(jcfg.parallel, data_parallel=1)
    params = jax_init(jax.random.PRNGKey(0), jcfg)
    jcoach = jengine.Coach(jcfg)
    jcoach.params = params
    jcoach.val_loader = DataLoader(SyntheticDataset(1, with_depth=True), 1)
    coach = Coach(cfg, device="cpu")
    coach.build_networks()
    coach.model.load_state_dict(state_dict_from_jax(params), strict=True)
    coach.val_loader = jcoach.val_loader

    # the renders and the cond-query wrapper each feature scale reaches
    renders, routes = {}, {"jax": [], "port": []}
    jfwd, tfwd = jcoach.renderer.forward, coach.renderer.forward
    monkeypatch.setattr(jcoach.renderer, "forward", lambda *a, **k: renders.setdefault(
        "jax", jfwd(*a, **k)))
    monkeypatch.setattr(coach.renderer, "forward", lambda *a, **k: renders.setdefault(
        "port", tfwd(*a, **k)))
    for mod, name, tag in ((pallas_block_banded, "block_banded_cosine_scale_trainable", "block"),
                           (pallas_banded, "banded_cosine_scale_trainable", "banded")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _tag=tag, **k: (
            routes["jax"].append(_tag), _fn(*a, **k))[1])
    for name, tag in (("block_cosine_prior", "block"), ("cosine_prior", "banded")):
        fn = getattr(tmn, name)
        monkeypatch.setattr(tmn, name, lambda *a, _fn=fn, _tag=tag, **k: (
            routes["port"].append(_tag), _fn(*a, **k))[1])

    jcoach.validate_model(iteration=7)
    metrics = coach.validate_model(iteration=7)
    assert coach.renderer.last_route["block_ut"] is not None
    assert routes["port"] == routes["jax"] == ["block", "block"]
    got = renders["port"]["rgb"].numpy().reshape(H, W, 3)
    want = np.asarray(renders["jax"]["rgb"]).reshape(H, W, 3)
    mse = float(np.mean((got.astype(np.float64) - want) ** 2))
    assert -10 * np.log10(max(mse, 1e-30)) >= 60.0
    with open(os.path.join(jcfg.output_path, "scalars.jsonl")) as f:
        jrec = json.loads(f.readline())
    with open(coach.scalars_path) as f:
        rec = json.loads(f.readline())
    assert rec["split"] == jrec["split"] == "val" and rec["step"] == 7
    np.testing.assert_allclose(rec["PSNR"], jrec["PSNR"], atol=1e-3)
    np.testing.assert_allclose(rec["SSIM"], jrec["SSIM"], atol=1e-4)
    assert os.path.exists(os.path.join(coach.output_path, "validation", "scene0_view3_it7.jpg"))
    assert metrics["PSNR"] == [rec["PSNR"]]


def test_visualize_depth_matches_cv2_jet():
    import cv2

    from matchnerf_tpu.utils.visualize import visualize_depth as jax_visualize_depth
    from matchnerf_tpu_torch.utils.visualize import jet_colormap, visualize_depth
    ramp = np.arange(256, dtype=np.uint8)[:, None]
    want = cv2.cvtColor(cv2.applyColorMap(ramp, cv2.COLORMAP_JET), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(jet_colormap(), want[:, 0])
    rng = np.random.default_rng(3)
    depth = rng.uniform(2.0, 4.5, (24, 31)).astype(np.float32)
    depth[:5, :7] = 0.0                   # no depth: outside the mask
    depth[6, 2] = np.nan
    for minmax in (None, [2.5, 4.0]):
        np.testing.assert_array_equal(visualize_depth(depth, minmax),
                                      jax_visualize_depth(depth, minmax))
