"""Training entry of the port (counterpart of train.py).

    python -m matchnerf_tpu_torch.train --config train \\
        --data_train.root_dir=data/DTU --data_val.root_dir=data/DTU \\
        --data_test.dtu.root_dir=data/DTU --data_test.llff= --data_test.blender= \\
        [--name=RUN] [--resume] [--cpu] [--key.sub=value ...]

`--config` names a configuration of `config.CONFIGS` (train:
configs/train.yaml, train_fast: configs/train_fast.yaml); every other
`--key=value` overrides it as the JAX entry's YAML overrides do (`--flag`
is true, `--flag!` false, `--key=` None). configs/train.yaml tests on DTU,
LLFF and Blender; the port has the DTU loader only, so `--data_test.llff=
--data_test.blender=` drop the other two. The run writes under
`<output_root>/<name>/`: `models/latest.ckpt` (resumable) and
`ep{E}_it{I}.ckpt` (weights), `validation/`, `test/`, `scalars.jsonl` and
`options.json`. `--resume` continues the run of that name from its
`latest.ckpt`. It runs on the card unless given `--cpu`.
"""
from __future__ import annotations

import logging
import sys
from typing import List, Optional


def build_coach(argv: Optional[List[str]] = None):
    """Everything `main` does before training, in train.py's order: the
    config with its overrides and run directory, the train, val and test
    loaders, the model, the optimizer, the checkpoint to resume or load and
    the visualizer. Returns the `engine.Coach`."""
    from .config import CONFIGS, override_options, parse_arguments, process_options
    from .engine import Coach

    opts = parse_arguments(sys.argv[1:] if argv is None else argv)
    name = opts.pop("config", "train")
    if name not in CONFIGS:
        raise SystemExit(f"unknown --config {name!r}; the port has {sorted(CONFIGS)}")
    device = "cpu" if opts.pop("cpu", False) else "cuda"
    cfg = override_options(CONFIGS[name](), opts)
    process_options(cfg)
    logging.getLogger(__name__).info("config %s on %s, output %s", name, device,
                                     cfg.output_path)
    coach = Coach(cfg, device=device)
    coach.load_dataset(["train", "val", "test"])
    coach.build_networks()
    coach.setup_optimizer()
    coach.restore_checkpoint_if_needed()
    coach.setup_visualizer()
    return coach


def main(argv: Optional[List[str]] = None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    coach = build_coach(argv)
    coach.train_model()
    return coach


if __name__ == "__main__":
    main()
