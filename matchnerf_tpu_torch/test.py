"""Evaluation and video entry of the port (counterpart of test.py).

    python -m matchnerf_tpu_torch.test --config test \\
        [--data_test.dtu.root_dir=DIR --data_test.dtu.meta_dir=DIR ...] \\
        [--data_test.tnt=] [--load=PATH | --load=] [--output_root=DIR] [--cpu] \\
        [--key.sub=value ...]

`--config` names a configuration of `config.CONFIGS`: test
(configs/test.yaml: the DTU, LLFF, Blender and T&T test sets), test_strict,
test_video, test_tnt, demo_own (the COLMAP printer scene of
configs/demo_own.yaml), test_video_own, train, train_fast. Every other
`--key=value` overrides it as the JAX entry's YAML overrides do (`--flag`
is true, `--flag!` false, `--key=` None: `--load=` keeps the seeded
weights, `--data_test.llff=` leaves a test set out). A set's
`meta_dir` names the directory of its `pairs.th` (default: configs/). With
`nerf.render_video` it renders the trajectory video
(`Coach.test_model_video`), otherwise the test views with their metrics
(`Coach.test_model`), under `<output_root>/<name>/`. It runs on the card
unless given `--cpu`. T&T's images are JPEGs, decoded by `data/jpeg.py`.
Several processes as `python -m matchnerf_tpu_torch.train` runs them (its
docstring): each rank renders its share of every slice's rays.
"""
from __future__ import annotations

import logging
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None):
    """Render. With no cluster configured and parallel.data_parallel asking
    for several of this host's cards (-1, the default: all), one worker per
    card is spawned; under several ranks each renders its share of every
    slice's rays (`Coach.setup_eval_parallel`) and rank 0 writes."""
    from .config import entry_config
    from .engine import Coach
    from .parallel import distributed as dist

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    argv = sys.argv[1:] if argv is None else list(argv)
    name, device, cfg = entry_config(argv, "demo_own")
    n = 1 if device == "cpu" else dist.local_workers(cfg)
    if n > 1:
        dist.spawn(main, n, argv)
        return None
    dist.maybe_initialize(cfg, device)
    coach = Coach(cfg, device=device)
    logging.getLogger(__name__).info("config %s on %s, output %s (rank %d of %d)", name,
                                     device, coach.output_path, dist.process_index(),
                                     dist.process_count())
    coach.load_dataset(["test"])
    coach.build_networks()
    coach.restore_checkpoint_if_needed()
    coach.setup_eval_parallel()
    if cfg.nerf.get("render_video"):
        return coach.test_model_video()
    return coach.test_model(save_images=True, separate_save=bool(cfg.get("separate_save")))


if __name__ == "__main__":
    main()
