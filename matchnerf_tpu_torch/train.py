"""Training entry of the port (counterpart of train.py).

    python -m matchnerf_tpu_torch.train --config train \\
        --data_train.root_dir=data/DTU --data_val.root_dir=data/DTU \\
        --data_test.dtu.root_dir=data/DTU --data_test.llff= --data_test.blender= \\
        [--name=RUN] [--resume] [--cpu] [--key.sub=value ...]

`--config` names a configuration of `config.CONFIGS` (train:
configs/train.yaml, train_fast: configs/train_fast.yaml, train_ibrnet:
configs/train_ibrnet.yaml); every other `--key=value` overrides it as the
JAX entry's YAML overrides do (`--flag` is true, `--flag!` false, `--key=`
None; `--data_test.llff=` drops a test set). train_ibrnet trains on the
IBRNet scenes at 1008x756 and tests on LLFF:

    python -m matchnerf_tpu_torch.train --config train_ibrnet \
        --data_train.root_dir=data/IBRNet --data_val.root_dir=data/IBRNet \
        --data_test.llff.root_dir=data/nerf_llff_data

`--encoder.pretrain_weight=<file>` (base.yaml names
configs/pretrained_models/gmflow_sintel-0c07dcb3.pth) starts the encoder
from a GMFlow checkpoint where that file exists (`--encoder.pretrain_weight=`
from the seed). The run writes under
`<output_root>/<name>/`: `models/latest.ckpt` (resumable) and
`ep{E}_it{I}.ckpt` (weights), `validation/`, `test/`, `scalars.jsonl` and
`options.json`. `--resume` continues the run of that name from its
`latest.ckpt`. It runs on the card unless given `--cpu`.

Several processes: `parallel.data_parallel` (-1: every visible card) spawns
one worker per card of this host. A cluster is set by `--parallel.*` or by
the variables MATCHNERF_COORDINATOR_ADDRESS (host:port of rank 0),
MATCHNERF_NUM_PROCESSES, MATCHNERF_PROCESS_ID and MATCHNERF_LOCAL_DEVICE_IDS
(the rank's card), or MATCHNERF_MULTIHOST=1 with torchrun's variables; two
ranks on the CPU:

    MATCHNERF_COORDINATOR_ADDRESS=127.0.0.1:29500 MATCHNERF_NUM_PROCESSES=2 \
    MATCHNERF_PROCESS_ID=0 python -m matchnerf_tpu_torch.train --cpu ... &
    MATCHNERF_COORDINATOR_ADDRESS=127.0.0.1:29500 MATCHNERF_NUM_PROCESSES=2 \
    MATCHNERF_PROCESS_ID=1 python -m matchnerf_tpu_torch.train --cpu ...

(without --cpu, the same runs two ranks on the card(s)). Rank 0 writes the
run's files; the ranks share `parallel_plan`'s mode (engine.py).
"""
from __future__ import annotations

import logging
import sys
from typing import List, Optional


def build_coach(argv: Optional[List[str]] = None, kernel: bool = True):
    """Everything `main` does before training, in train.py's order: the
    config with its overrides, the process group where one is configured
    (`parallel.distributed.maybe_initialize`, before the run is named), the
    run directory, the train, val and test loaders, the model, the
    optimizer, the checkpoint to resume or load (every rank then holding
    rank 0's state) and the visualizer. Returns the `engine.Coach`;
    kernel=False gives it every kernel's plain version (the all-plain
    reference run on the card)."""
    from .config import entry_config, process_options
    from .engine import Coach
    from .parallel import distributed as dist

    name, device, cfg = entry_config(sys.argv[1:] if argv is None else argv, "train")
    dist.maybe_initialize(cfg, device)
    process_options(cfg)
    logging.getLogger(__name__).info("config %s on %s, output %s (rank %d of %d)", name,
                                     device, cfg.output_path, dist.process_index(),
                                     dist.process_count())
    coach = Coach(cfg, device=device, kernel=kernel)
    coach.load_dataset(["train", "val", "test"])
    coach.build_networks()
    coach.setup_optimizer()
    coach.restore_checkpoint_if_needed()
    coach.setup_visualizer()
    return coach


def main(argv: Optional[List[str]] = None):
    """Train. With no cluster configured and parallel.data_parallel asking
    for several of this host's cards (-1, the default: all), one worker per
    card is spawned, each a rank of a rendezvous on 127.0.0.1."""
    from .config import entry_config
    from .parallel import distributed as dist

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    argv = sys.argv[1:] if argv is None else list(argv)
    _, device, cfg = entry_config(argv, "train")
    n = 1 if device == "cpu" else dist.local_workers(cfg)
    if n > 1:
        dist.spawn(main, n, argv)
        return None
    coach = build_coach(argv)
    coach.train_model()
    return coach


if __name__ == "__main__":
    main()
