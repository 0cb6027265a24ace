"""What PNG decoding costs a training loop on the card.

    python -m matchnerf_tpu_torch.profile_loop [--steps 12] [--config train ...]

Writes the synthetic 640x512 DTU scan (`data/synth.py::write_dtu_scene`,
PNG rows adaptively filtered) under build/profile_loop/, then runs the
training CLI's `build_coach` + `train_model` for --steps steps of one
epoch, with no validation, test or mid-epoch checkpoint, four times per
recipe in turns: the loader decoding its PNGs, the loader fed images
decoded beforehand, again pre-decoded, again decoding. Prints for each run
the steps/s over the warm steps (all but the first, synchronised at both
ends) and, once per recipe, the loader's seconds per sample alone, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_args(label, root, meta, runs, steps):
    args = {"name": f"profile_{label}", "output_root": runs, "max_epoch": 1, "tb": "false",
            "encoder.pretrain_weight": "", "freq.val_it": -1, "freq.test_ep": -1,
            "freq.ckpt_it": -1, "freq.ckpt_ep": -1, "data_train.max_len": steps,
            "data_val.max_len": 1, "data_test.dtu.max_len": 1, "data_test.llff": "",
            "data_test.blender": ""}
    for block in ("data_train", "data_val", "data_test.dtu"):
        args[f"{block}.root_dir"] = root
        args[f"{block}.meta_dir"] = meta
    return ["--config", label] + [f"--{k}={v}" for k, v in args.items()]


def timed_loop(torch, coach, steps):
    """Warm steps/s of `coach.train_model()`: steps 2..N between a
    synchronise after the first step and one after the last."""
    marks = []
    step = coach.step

    def marked(*a, **k):
        out = step(*a, **k)
        if len(marks) in (0, steps - 1):
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return out

    coach.step = marked
    coach.train_model()
    torch.cuda.synchronize()
    if len(marks) != steps:
        raise RuntimeError(f"{len(marks)} steps taken, expected {steps}")
    return (steps - 1) / (marks[-1] - marks[0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--config", nargs="+", default=["train", "train_fast"])
    args = ap.parse_args(argv)
    import torch

    from .data import dtu, synth
    from .data.common import load_images
    from .train import build_coach
    if not torch.cuda.is_available():
        raise SystemExit("profile_loop times the loop on the card: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    work = os.path.join(REPO, "build", "profile_loop")
    shutil.rmtree(work, ignore_errors=True)
    root, meta, runs = (os.path.join(work, d) for d in ("DTU", "meta", "runs"))
    synth.write_dtu_scene(root, meta)
    rect = os.path.join(root, "Rectified", "scan1_train")
    decoded = {os.path.join(rect, f): img for f, img in zip(
        sorted(os.listdir(rect)), load_images(
            [os.path.join(rect, f) for f in sorted(os.listdir(rect))], (640, 512)))}

    def predecoded(paths, img_wh, resample="lanczos"):
        return [decoded[p] for p in paths]

    for label in args.config:
        rates = {"decoding": [], "pre-decoded": []}
        for mode in ("decoding", "pre-decoded", "pre-decoded", "decoding"):
            dtu.load_images = predecoded if mode == "pre-decoded" else load_images
            try:
                coach = build_coach(run_args(label, root, meta, runs, args.steps))
                rates[mode].append(timed_loop(torch, coach, args.steps))
            finally:
                dtu.load_images = load_images
            print(f"{label}.yaml, loader {mode}: {rates[mode][-1]:.4f} warm steps/s "
                  f"({args.steps} steps)", flush=True)
        data = coach.train_loader.dataset
        t0 = time.perf_counter()
        for i in range(args.steps):
            data[i]
        sample_s = (time.perf_counter() - t0) / args.steps
        print(f"{label}.yaml: decoding {rates['decoding']} steps/s, pre-decoded "
              f"{rates['pre-decoded']} steps/s; the loader alone {sample_s:.4f} s a sample "
              f"({1 / sample_s:.3f} samples/s); {card.strip()}", flush=True)
        del coach
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
