"""How often a torch.profiler trace of one wrapper call comes back without
device kernels, on the card.

    python -m matchnerf_tpu_torch.profile_traces [--trials 500] [--seed 0]

Traces Kernel D's wrapper (bf16 table [3,64,80,256], G=2, bucket 160, S=128,
4096 and 20480 rays inside one union bucket) `--trials` times in each of two
forms, in turns: one call with the trace stopped right after it, and three
calls with 5 ms of idle host time at both ends of the trace (the form of
chip_smoke.py's `kernel_names`). Prints per form the traces that recorded no
device kernel and those that recorded a kernel other than D's.
"""
from __future__ import annotations

import argparse
import time

FORMS = {"one call, no idle ends": (1, 0.0), "three calls, 5 ms idle ends": (3, 0.005)}


def traced_names(torch, fn, iters, pad_s):
    """The device kernels of `iters` calls of `fn` in one trace, with
    `pad_s` seconds of idle host time at both ends."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return {e.key for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.device_time_total > 0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    from . import kernels
    from .ops import block_cosine_prior as kd

    if not torch.cuda.is_available():
        raise SystemExit("profile_traces: needs a CUDA device")
    kernels.library()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    table = torch.randn(3, 64, 80, 256, generator=gen, device="cuda").to(torch.bfloat16)
    for rays in (4096, 20480):
        # samples within 5 % of the map's centre: every 8-ray union fits bucket 160
        grids = torch.rand(3, rays, 128, 2, generator=gen, device="cuda") * 0.1 - 0.05
        fn = lambda: kd.block_cosine_prior(table, grids, None, 2, 160)
        counts = {form: {"empty": 0, "other": 0} for form in FORMS}
        t0 = time.perf_counter()
        for _ in range(args.trials):
            for form, (iters, pad_s) in FORMS.items():
                names = traced_names(torch, fn, iters, pad_s)
                if not names:
                    counts[form]["empty"] += 1
                elif any("block_cosine_prior" not in k for k in names):
                    counts[form]["other"] += 1
        for form, c in counts.items():
            print(f"{rays} rays, {form}: {c['empty']} of {args.trials} traces recorded no "
                  f"device kernel, {c['other']} a kernel other than D's", flush=True)
        print(f"{rays} rays: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
