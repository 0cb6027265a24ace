"""One rank of the 2-process CPU job of tests/test_torch_parallel.py.

    MATCHNERF_COORDINATOR_ADDRESS=127.0.0.1:PORT MATCHNERF_NUM_PROCESSES=2 \\
    MATCHNERF_PROCESS_ID=RANK python tests/torch_parallel_worker.py JOB OUT

JOB (torch.save'd by the test) holds plain-dict configs, the weights as a
state_dict, numpy batches and the JAX package's draws. The rank brings up
the process group from the MATCHNERF_* variables (gloo on the CPU), runs
every case and saves what the test compares to OUT.<rank>.pt: one training
step per parallel mode (rays, batch, train_fast strips), the ray-sharded
eval render with the eval encoder's streams sharded and not, and the Coach
level (two iterations, a checkpoint, the resume). Imports nothing of JAX.
"""
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model_from(cfg, state):
    from matchnerf_tpu_torch.models.matchnerf import MatchNeRF
    model = MatchNeRF(cfg)
    model.load_state_dict(state, strict=True)
    return model


def train_case(case, weights):
    """One step of the mode the plan picks: the loss, the averaged
    gradients, the parameters after the update and the pixels this rank
    rendered."""
    from matchnerf_tpu_torch import train_step
    from matchnerf_tpu_torch.engine import Coach
    from matchnerf_tpu_torch.parallel import mesh
    from matchnerf_tpu_torch.utils.containers import DotDict
    cfg = DotDict(case["cfg"])
    model = model_from(cfg, weights)
    coach = Coach(cfg, model, "cpu")
    coach.setup_optimizer(case["total_steps"])
    pixels, grads = [], {}
    render, update = train_step.render_rays, coach.opt.step

    def capture():                    # the averaged gradients, before the clip and update
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        update()

    coach.opt.step = capture

    def spy(*args, **kwargs):
        pixels.append(args[2][0].clone())
        return render(*args, **kwargs)

    train_step.render_rays = spy
    try:
        rows = (mesh.chunk(len(case["batch"]["images"])) if case["shard_batch"]
                else slice(None))
        batch = {k: v[rows] for k, v in case["batch"].items()}
        route = coach.train_route(batch)
        loss = coach.step(coach.batch_tensors(batch), route, torch.as_tensor(case["ray_idx"]),
                          torch.as_tensor(case["depth_rand"]))
    finally:
        train_step.render_rays = render
    return {"mode": coach.parallel_mode, "route": route, "loss": float(loss["all"]),
            "grads": grads, "params": {k: v.clone() for k, v in model.state_dict().items()},
            "pixels": pixels[0]}


def eval_case(case, weights):
    from matchnerf_tpu_torch.renderer import Renderer
    from matchnerf_tpu_torch.utils.containers import DotDict
    out = {}
    for key, cfg in case["cfgs"].items():
        cfg = DotDict(cfg)
        renderer = Renderer(cfg, model_from(cfg, weights).eval(), "cpu")
        renderer.set_ray_sharding(True)
        ret = renderer.forward(case["batch"], mode="test")
        out[key] = {"rgb": ret["rgb"], "depth": ret["depth"], "route": renderer.last_route,
                    "shard_streams": renderer.shard_streams()}
    return out


def coach_case(case, weights, rank, out_dir):
    """Two train_iterations and a checkpoint under a run name that differs
    per rank before process_options; then the resume from another seed's
    weights, rank 1's output_root holding no checkpoint."""
    from matchnerf_tpu_torch.config import process_options
    from matchnerf_tpu_torch.engine import Coach
    from matchnerf_tpu_torch.models.matchnerf import init_matchnerf
    from matchnerf_tpu_torch.utils.containers import DotDict

    def configured(resume):
        cfg = DotDict(case["cfg"])
        cfg.name = f"run_of_rank{rank}"
        cfg.output_root = os.path.join(out_dir, f"root{rank}")
        cfg.resume = resume
        before = cfg.name
        process_options(cfg)
        return cfg, before

    cfg, before = configured(False)
    coach = Coach(cfg, model_from(cfg, weights), "cpu")
    coach.setup_optimizer(case["total_steps"])
    coach.restore_checkpoint_if_needed()
    coach.setup_visualizer()
    losses = [float(coach.train_iteration(case["batch"])["all"]) for _ in range(2)]
    coach.save_checkpoint_now(ep=0, it=coach.it, backup_ckpt=False)
    coach.checkpoints.wait()
    saved = {k: v.clone() for k, v in coach.model.state_dict().items()}

    cfg2, _ = configured(True)
    other = init_matchnerf(cfg2, torch.Generator().manual_seed(1 + rank))
    resumed = Coach(cfg2, other, "cpu")
    resumed.setup_optimizer(case["total_steps"])
    resumed.restore_checkpoint_if_needed()
    return {"name_before": before, "name": cfg.name, "output_path": cfg.output_path,
            "losses": losses, "saved": saved,
            "resumed": {k: v.clone() for k, v in resumed.model.state_dict().items()},
            "resumed_opt_count": resumed.opt.count,
            "resumed_start": (resumed.epoch_start, resumed.iter_start)}


def main(job_path, out_path):
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from matchnerf_tpu_torch.parallel import distributed as dist
    from matchnerf_tpu_torch.parallel import mesh

    assert dist.maybe_initialize(None, "cpu"), "the MATCHNERF_* variables must bring it up"
    rank = dist.process_index()
    job = torch.load(job_path, weights_only=False)
    weights = job["weights"]
    out = {"rank": rank, "world": dist.process_count(), "backend": dist.backend()}
    # the gathers on an uneven split (3 rows over 2 ranks) and the gradient
    x = torch.arange(6.0).reshape(3, 2).requires_grad_()
    local = x[mesh.stream_rows(3)] * (rank + 1.0)
    full = mesh.gather_rows(local, 3)
    full.sum().backward()
    out["gather"] = {"full": full.detach(), "grad": x.grad}
    # one row over 2 ranks: rank 1 holds only padding, and still a gradient
    y = torch.ones(1, 2).requires_grad_()
    mesh.gather_rows(y[mesh.stream_rows(1)] * (rank + 1.0), 1).sum().backward()
    out["gather"]["grad_one_row"] = y.grad
    out["train"] = {name: train_case(case, weights) for name, case in job["train"].items()}
    out["eval"] = eval_case(job["eval"], weights)
    out["coach"] = coach_case(job["coach"], weights, rank, os.path.dirname(out_path))
    torch.save(out, f"{out_path}.{rank}.pt")
    dist.shutdown()


def probe(out_dir):
    """A worker of `distributed.spawn`: its rank, world and backend."""
    sys.path.insert(0, REPO)
    from matchnerf_tpu_torch.parallel import distributed as dist
    dist.maybe_initialize(None, "cpu")
    rank = dist.process_index()
    with open(os.path.join(out_dir, f"probe{rank}.txt"), "w") as f:
        f.write(f"{rank} {dist.process_count()} {dist.backend()} "
                f"{dist.broadcast_str(f'from rank {rank}')}")
    dist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
