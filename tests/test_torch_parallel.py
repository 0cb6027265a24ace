"""The port's parallel layer (matchnerf_tpu_torch/parallel/, the step's
modes, the ray-sharded renderer, the engine's rank-0 writes) vs the JAX
package's mesh, on the CPU with gloo.

One 2-rank job per module (`job`): two processes of
tests/torch_parallel_worker.py brought up by the MATCHNERF_* variables, as
tests/test_multihost.py brings up the JAX package's, each with
torch.set_num_threads(1), at `ge._tiny_cfg(n_layers=1, sample_intvs=4)`.
The JAX references run in this process while the ranks work. Held:

- one training step in each mode, fed JAX's ray and depth draws: rays
  (batch 1, 32 rays at 16x16, the encoder's streams sharded), batch (B = 2,
  each rank its sample) and train_fast strips (each rank 2 whole 8-pixel
  strips through D', its plain version here). The ranks' loss and every
  updated parameter against the JAX one-device `make_train_step` and the
  JAX `make_mesh(2)` step at JAX's own budget (tests/test_sharding.py:100-108:
  loss rtol 2e-5, parameters rtol 5e-5 / atol 5e-6); the port's
  one-process step held to the same budget; the ranks' parameters equal;
- the ray-sharded eval render with configs/test.yaml's precision (the block
  path) at 16x32: the ranks' images bit-equal to each other; with
  parallel.shard_encoder_streams_eval false bit-equal to the port's
  one-process render; with it on >= 60 dB against the JAX one-process
  render (tests/test_multihost.py:319-321);
- the Coach: two `train_iteration`s, a checkpoint and the resume: rank 0
  alone writes the checkpoint, scalars.jsonl and options.json; rank 1, whose
  output_root holds no checkpoint, adopts rank 0's state; both ranks agree
  on a run name that differed before the broadcast;
- without processes: `parallel_plan` against JAX `Coach._parallel_plan`,
  the loader's shards against the JAX loader's over two epochs (and a
  dataset's draws in step with the one-process loader), the backend rule,
  and `distributed.spawn` with 2 workers.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.parallel import make_mesh
from matchnerf_tpu.renderer import Renderer as JaxRenderer
from matchnerf_tpu.renderer import extract_poses as jax_extract_poses
from matchnerf_tpu.train_step import build_optimizer as jax_build_optimizer
from matchnerf_tpu.train_step import make_train_step as jax_make_train_step
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch.engine import Coach, parallel_plan
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF
from matchnerf_tpu_torch.parallel import distributed as dist
from matchnerf_tpu_torch.renderer import Renderer
from matchnerf_tpu_torch.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N_RAYS, S, T = 16, 16, 32, 4, 50
EVAL_H, EVAL_W = 16, 32
LOSS_RTOL, P_RTOL, P_ATOL = 2e-5, 5e-5, 5e-6
G_TOL = (2e-3, 5e-6)                      # gradients vs JAX one-device, rtol / atol
# vs the JAX mesh step: G_TOL's atol plus that step's own distance from the
# JAX one-device gradient, measured 4.1e-6 (backbone.conv1.weight, rays mode)
G_TOL_MESH = (2e-3, 1e-5)
MODES = ("rays", "batch", "strips")


def _train_cfg(mode):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=S)))
    B = 2 if mode == "batch" else 1
    cfg.batch_size = B
    cfg.encoder = DotDict({**cfg.encoder, "attention_backend": "xla"})
    cfg.nerf = DotDict({**cfg.nerf, "rand_rays_train": N_RAYS * B,
                        "train_ray_patches": mode == "strips"})
    cfg.precision = DotDict({"encoder_compute_dtype": "float32",
                             "decoder_compute_dtype": "float32",
                             "banded_kernel": True, "block_kernel": True})
    cfg.parallel = DotDict({"data_parallel": -1, "shard_encoder_streams": True,
                            "shard_encoder_streams_eval": True})
    cfg.data_train = DotDict({"img_wh": [W, H]})
    cfg.freq = DotDict({"scalar": 1})
    return cfg


def _eval_cfg(streams):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=1, sample_intvs=8)))
    cfg.precision = DotDict({"cond_sample_dtype": "int8", "color_sample_dtype": "uint8",
                             "banded_kernel": True, "block_kernel": True,
                             "decoder_kernel": True, "color_block_kernel": True})
    cfg.parallel = DotDict({"shard_encoder_streams_eval": streams})
    return cfg


def _plain(cfg):
    return json.loads(json.dumps(cfg))


def _draws(key, mode):
    """JAX loss_fn's ray indices and depth jitter (train_step.py:160-187)."""
    B = 2 if mode == "batch" else 1
    rng_rays, rng_depth = jax.random.split(key)
    if mode == "strips":
        starts = jax.random.permutation(rng_rays, H * W // 8)[:N_RAYS // 8] * 8
        idx = (starts[:, None] + jnp.arange(8)[None]).reshape(-1)
    else:
        idx = jax.random.permutation(rng_rays, H * W)[:N_RAYS]
    return np.asarray(idx), np.asarray(jax.random.uniform(rng_depth, (B, N_RAYS, S, 1)))


def _train_inputs(mode):
    cfg = _train_cfg(mode)
    d = ge._synthetic_inputs(cfg, cfg.batch_size, H, W, R=N_RAYS)
    batch = {"images": d["images"], "extrinsics": d["poses"], "intrinsics": d["intr"],
             "near_fars": d["near_fars"]}
    return cfg, batch, d["tgt_c2w"]


def _jax_steps(mode, params):
    """(one-device, make_mesh(2)) -> (loss, gradients as a state_dict): the
    JAX step with an optax transform that keeps the gradients as its state."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    cfg, batch, c2w = _train_inputs(mode)
    batch_j = {**{k: jnp.asarray(v) for k, v in batch.items()}, "tgt_c2w": jnp.asarray(c2w)}
    grab = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    key = jax.random.PRNGKey(7)
    out = {}
    _, g1, l1 = jax_make_train_step(cfg, grab, H, W, N_RAYS)(params, grab.init(params),
                                                              batch_j, key)
    out["one_device"] = (float(l1["all"]), state_dict_from_jax(g1))
    mesh = make_mesh(n_devices=2)
    repl = NamedSharding(mesh, P())
    data = NamedSharding(mesh, P("data")) if mode == "batch" else repl
    step = jax_make_train_step(cfg, grab, H, W, N_RAYS, mesh=mesh, shard_rays=mode != "batch")
    _, g2, l2 = step(jax.device_put(params, repl), jax.device_put(grab.init(params), repl),
                     {k: jax.device_put(v, data) for k, v in batch_j.items()}, key)
    out["mesh2"] = (float(l2["all"]), state_dict_from_jax(g2))
    return out


def _port_one_process(mode, weights):
    """(loss, gradients, parameters after the update) of the port's step in
    one process."""
    cfg, batch, _ = _train_inputs(mode)
    model = MatchNeRF(cfg)
    model.load_state_dict(weights, strict=True)
    coach = Coach(cfg, model, "cpu")
    coach.setup_optimizer(T)
    idx, rand = _draws(jax.random.PRNGKey(7), mode)
    grads, update = {}, coach.opt.step

    def capture():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        update()

    coach.opt.step = capture
    loss = coach.step(coach.batch_tensors(batch), coach.train_route(batch),
                      torch.as_tensor(idx), torch.as_tensor(rand))
    return float(loss["all"]), grads, model.state_dict()


def _eval_batch():
    cfg = _eval_cfg(True)
    d = ge._synthetic_inputs(cfg, 1, EVAL_H, EVAL_W, R=16)
    return {"images": d["images"], "extrinsics": d["poses"], "intrinsics": d["intr"],
            "near_fars": d["near_fars"]}, d


def _jax_render(cfg, params):
    """The JAX one-process render of the eval batch (tests/test_multihost.py's
    reference)."""
    _, d = _eval_batch()
    jr = JaxRenderer(cfg)
    poses = jax_extract_poses({"extrinsics": d["poses"], "intrinsics": d["intr"],
                               "near_fars": d["near_fars"]})
    ref_images = jnp.asarray(d["images"][:, :cfg.n_src_views])
    feats = jr.encode(params, ref_images)
    tables = jr.build_tables(ref_images, feats)
    return jr.render_by_slices(params, poses, ref_images, feats, EVAL_H, EVAL_W,
                               tables=tables)


def _launch(tmp, job):
    job_path = os.path.join(tmp, "job.pt")
    torch.save(job, job_path)
    port = dist.free_port()
    procs, logs = [], []
    for rank in range(2):
        env = dict(os.environ)
        env.update(MATCHNERF_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   MATCHNERF_NUM_PROCESSES="2", MATCHNERF_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1")
        env.pop("PYTHONSTARTUP", None)
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_parallel_worker.py"),
             job_path, os.path.join(tmp, "out")],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs, logs


def _wait(tmp, procs, logs, timeout=300):
    import time
    t0 = time.time()
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.time() - t0 > timeout:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                raise AssertionError(f"rank {rank} exit {p.returncode}:\n{f.read()[-6000:]}")
    return [torch.load(os.path.join(tmp, f"out.{r}.pt"), weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Start the 2 ranks, compute the references meanwhile, return both."""
    tmp = str(tmp_path_factory.mktemp("torch_parallel"))
    params = jax_init(jax.random.PRNGKey(0), _train_cfg("rays"))
    weights = state_dict_from_jax(params)
    train = {}
    for mode in MODES:
        cfg, batch, _ = _train_inputs(mode)
        idx, rand = _draws(jax.random.PRNGKey(7), mode)
        train[mode] = {"cfg": _plain(cfg), "batch": batch, "shard_batch": mode == "batch",
                       "ray_idx": idx, "depth_rand": rand, "total_steps": T}
    eval_batch, _ = _eval_batch()
    coach_cfg, coach_batch, _ = _train_inputs("rays")
    coach_cfg.seed = 0
    job_spec = {"weights": weights, "train": train,
                "eval": {"batch": eval_batch,
                         "cfgs": {"streams_on": _plain(_eval_cfg(True)),
                                  "streams_off": _plain(_eval_cfg(False))}},
                "coach": {"cfg": _plain(coach_cfg), "batch": coach_batch, "total_steps": T}}
    procs, logs = _launch(tmp, job_spec)
    threads = torch.get_num_threads()
    try:
        # the port's one-process references on one thread, as the ranks run
        # (a CPU matmul's sums can split differently on several threads)
        torch.set_num_threads(1)
        refs = {"port": {m: _port_one_process(m, weights) for m in MODES}}
        cfg = _eval_cfg(True)
        model = MatchNeRF(cfg)
        model.load_state_dict(weights, strict=True)
        refs["eval_port"] = Renderer(cfg, model.eval(), "cpu").forward(eval_batch, mode="test")
        torch.set_num_threads(threads)
        refs["jax"] = {m: _jax_steps(m, params) for m in MODES}
        refs["eval_jax"] = _jax_render(cfg, params)
    finally:
        torch.set_num_threads(threads)
        outs = _wait(tmp, procs, logs)
    return {"tmp": tmp, "ranks": outs, "refs": refs, "weights": weights}


def _close(got, want, label, rtol, atol):
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{label}: {name}")


def test_ranks_came_up_on_gloo(job):
    for rank, out in enumerate(job["ranks"]):
        assert (out["rank"], out["world"], out["backend"]) == (rank, 2, "gloo")


def test_gather_rows_uneven_and_its_gradient(job):
    """3 rows over 2 ranks (rank 1 pads with row 2): every rank holds the
    3 rows; backward, each row's cotangent is summed over the ranks (2)
    and lands on the rank that gave the row, the padding row getting 0;
    and a rank with no row of its own gets a gradient of zeros."""
    want = torch.tensor([[0.0, 1.0], [2.0, 3.0], [8.0, 10.0]])
    grads = [torch.tensor([[2.0, 2.0], [2.0, 2.0], [0.0, 0.0]]),
             torch.tensor([[0.0, 0.0], [0.0, 0.0], [4.0, 4.0]])]
    for out, g in zip(job["ranks"], grads):
        assert torch.equal(out["gather"]["full"], want)
        assert torch.equal(out["gather"]["grad"], g)
    # one row over 2 ranks: rank 1, past the end, gets a gradient of zeros
    assert torch.equal(job["ranks"][0]["gather"]["grad_one_row"], torch.full((1, 2), 2.0))
    assert torch.equal(job["ranks"][1]["gather"]["grad_one_row"], torch.zeros(1, 2))


@pytest.mark.parametrize("mode", MODES)
def test_sharded_step_matches_jax(job, mode):
    """The ranks' step (mode picked by `parallel_plan`): loss rtol 2e-5 and
    every updated parameter rtol 5e-5 / atol 5e-6 (JAX's sharding budget)
    against the port's one-process step; loss rtol 2e-5 and the averaged
    gradients atol 5e-6 / rtol 2e-3 (tests/test_torch_train_step.py's f32
    budget) against the JAX one-device step, atol 1e-5 against the JAX
    2-device mesh step (G_TOL_MESH); the port's one-process step against
    the JAX one-device step the same; the ranks' parameters equal.

    The updated parameters are not held to JAX: AdamW's first update
    lr g / (|g| + 1e-8) turns the frameworks' last-bit gradient differences
    into a sizeable share of lr where |g| ~ 1e-8, so even the port's
    one-process step misses rtol 5e-5 / atol 5e-6 against JAX at 1-2 of
    16384 entries of a decoder weight (measured: 6.9e-6 on
    nerf_dec.feature_linear.weight where JAX's gradient is 1.9e-8)."""
    r0, r1 = (out["train"][mode] for out in job["ranks"])
    assert r0["mode"] == r1["mode"] == ("batch" if mode == "batch" else "rays")
    if mode == "strips":
        assert r0["route"] is not None and None not in r0["route"]      # D' at both scales
    else:
        assert r0["route"] is None                                       # B' at both scales
    assert r0["loss"] == r1["loss"]
    for name in r0["params"]:
        assert torch.equal(r0["params"][name], r1["params"][name]), name
    loss, grads, params = job["refs"]["port"][mode]
    np.testing.assert_allclose(r0["loss"], loss, rtol=LOSS_RTOL)
    _close(r0["params"], params, f"{mode}: ranks vs one process", P_RTOL, P_ATOL)
    jax_refs = job["refs"]["jax"][mode]
    for label, (jloss, jgrads) in jax_refs.items():
        np.testing.assert_allclose(r0["loss"], jloss, rtol=LOSS_RTOL, err_msg=label)
        _close(r0["grads"], jgrads, f"{mode}: ranks vs JAX {label}",
               *(G_TOL if label == "one_device" else G_TOL_MESH))
    np.testing.assert_allclose(loss, jax_refs["one_device"][0], rtol=LOSS_RTOL)
    _close(grads, jax_refs["one_device"][1], f"{mode}: one process vs JAX", *G_TOL)


@pytest.mark.parametrize("mode", ["rays", "strips"])
def test_ray_shares(job, mode):
    """Rays mode: each rank renders its contiguous half of the global rays
    (JAX's draws); strips: each half is whole 8-pixel strips."""
    idx, _ = _draws(jax.random.PRNGKey(7), mode)
    for rank, out in enumerate(job["ranks"]):
        pix = out["train"][mode]["pixels"]                     # [16, 2] pixel centres
        got = (pix[:, 1].floor() * W + pix[:, 0].floor()).long().numpy()
        np.testing.assert_array_equal(got, idx[rank * N_RAYS // 2:(rank + 1) * N_RAYS // 2])
        if mode == "strips":
            strips = got.reshape(-1, 8)
            assert (strips[:, 0] % 8 == 0).all() and (np.diff(strips, axis=1) == 1).all()


def test_sharded_eval_render(job):
    """Both ranks hold the same image; with the eval encoder's streams
    whole it is bit-equal to the one-process render, with them sharded
    >= 60 dB against JAX's one-process render; the block route."""
    ev = [out["eval"] for out in job["ranks"]]
    for key in ("streams_on", "streams_off"):
        assert torch.equal(ev[0][key]["rgb"], ev[1][key]["rgb"]), key
        assert torch.equal(ev[0][key]["depth"], ev[1][key]["depth"]), key
        assert ev[0][key]["route"]["block_ut"] is not None, ev[0][key]["route"]
    assert ev[0]["streams_on"]["shard_streams"] and not ev[0]["streams_off"]["shard_streams"]
    ref = job["refs"]["eval_port"]
    assert torch.equal(ev[0]["streams_off"]["rgb"], ref["rgb"])
    assert torch.equal(ev[0]["streams_off"]["depth"], ref["depth"])
    mse = float(np.mean((ev[0]["streams_on"]["rgb"].numpy()
                         - np.asarray(job["refs"]["eval_jax"]["rgb"])) ** 2))
    psnr = np.inf if mse == 0 else -10 * np.log10(mse)
    assert psnr >= 60.0, psnr


def test_coach_rank0_writes_and_resume(job):
    c0, c1 = (out["coach"] for out in job["ranks"])
    assert (c0["name_before"], c1["name_before"]) == ("run_of_rank0", "run_of_rank1")
    assert c0["name"] == c1["name"] == "run_of_rank0"
    assert c0["losses"] == c1["losses"] and all(np.isfinite(c0["losses"]))
    files0 = sorted(os.listdir(c0["output_path"]))
    assert {"options.json", "run.bash", "scalars.jsonl", "models"} <= set(files0), files0
    assert os.listdir(os.path.join(c0["output_path"], "models")) == ["latest.ckpt"]
    assert os.listdir(c1["output_path"]) == [], os.listdir(c1["output_path"])
    with open(os.path.join(c0["output_path"], "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    for c in (c0, c1):
        assert c["resumed_start"] == (0, 2) and c["resumed_opt_count"] == 2
        for name, v in c0["saved"].items():
            assert torch.equal(c["resumed"][name], v), name


# ------------------------------- no processes -------------------------------

@pytest.mark.parametrize("bsz", [1, 2, 4, 6])
def test_parallel_plan_matches_jax(bsz, monkeypatch):
    """`parallel_plan` against JAX `Coach._parallel_plan` with the JAX
    package's device view patched to d processes of one device each, over
    rand_rays_train, data_parallel and d."""
    from matchnerf_tpu.engine import Coach as JaxCoach
    for d in (1, 2, 3, 4, 8):
        monkeypatch.setattr(jax, "devices", lambda d=d: list(range(d)))
        monkeypatch.setattr(jax, "process_count", lambda d=d: d)
        for rays in (0, 6, 16, 1024):
            for dp in (-1, 0, 1, 2, 3, 8):
                cfg = DotDict({"batch_size": bsz, "nerf": {"rand_rays_train": rays},
                               "parallel": {"data_parallel": dp}})
                jc = JaxCoach.__new__(JaxCoach)
                jc.cfg = cfg
                assert parallel_plan(cfg, d) == jc._parallel_plan(), (bsz, d, rays, dp)


class _DrawingDataset:
    """Samples that draw from the dataset's generator, as DTU's training
    split draws its sources."""

    def __init__(self, n):
        self.n = n
        self.rng = np.random.default_rng(0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": int(i), "draw": int(self.rng.integers(1 << 30))}

    def skip_sample(self, i):
        self.rng.integers(1 << 30)


@pytest.mark.parametrize("n,bsz,shards", [(10, 4, 2), (13, 6, 3), (8, 2, 2), (7, 1, 1)])
def test_loader_shards_match_jax(n, bsz, shards):
    """Every shard's batches equal the JAX loader's for two epochs, the
    lengths equal, and the samples' draws are those of the one-process
    loader (other shards' draws and the dropped tail's made too)."""
    from matchnerf_tpu.data.loader import DataLoader as JaxLoader
    from matchnerf_tpu_torch.data.loader import DataLoader
    single = DataLoader(_DrawingDataset(n), bsz, shuffle=True, seed=3)
    draws = {}
    for epoch in range(2):
        for batch in single:
            draws.update({(epoch, i): d for i, d in zip(batch["i"], batch["draw"])})
    for sid in range(shards):
        jl = JaxLoader(list(range(n)), bsz, shuffle=True, seed=3, num_workers=1,
                       num_shards=shards, shard_id=sid)
        pl = DataLoader(_DrawingDataset(n), bsz, shuffle=True, seed=3, num_shards=shards,
                        shard_id=sid)
        assert len(pl) == len(jl)
        for epoch in range(2):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            want = [list(map(int, b)) for b in jl._batch_indices()]
            assert [list(map(int, b)) for b in pl.batch_indices()] == want
            got = list(pl)
            assert [list(map(int, b["i"])) for b in got] == want
            for b in got:
                for i, d in zip(b["i"], b["draw"]):
                    assert draws[(epoch, int(i))] == int(d)


def test_backend_rule():
    """NCCL only where every rank has a card of its own."""
    assert dist.choose_backend(["h0/GPU-a", "h0/GPU-b", "h1/GPU-a"]) == "nccl"
    assert dist.choose_backend(["h0/GPU-a"]) == "nccl"
    assert dist.choose_backend(["h0/GPU-a", "h0/GPU-a"]) == "gloo"
    assert dist.choose_backend([None, None]) == "gloo"
    assert dist.choose_backend(["h0/GPU-a", None]) == "gloo"


def test_single_process_touches_no_process_group():
    assert not dist.maybe_initialize({"parallel": {"coordinator_address": None}}, "cpu")
    assert (dist.process_index(), dist.process_count(), dist.backend()) == (0, 1, None)
    assert dist.broadcast_str("x") == "x" and dist.broadcast_tree({"a": 1}) == {"a": 1}
    assert not torch.distributed.is_initialized()


def test_spawn_two_workers(tmp_path):
    """`distributed.spawn` (the entries' spawner): 2 workers, ranks 0 and 1
    of one gloo group, rank 0's string broadcast."""
    import torch_parallel_worker
    dist.spawn(torch_parallel_worker.probe, 2, str(tmp_path))
    for rank in range(2):
        assert (tmp_path / f"probe{rank}.txt").read_text() == f"{rank} 2 gloo from rank 0"
