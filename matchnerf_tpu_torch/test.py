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
unless given `--cpu`. T&T's images are JPEGs, which only PIL decodes here:
where PIL is not installed, leave that set out with `--data_test.tnt=`.
"""
from __future__ import annotations

import logging
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None):
    from .config import CONFIGS, override_options, parse_arguments
    from .engine import Coach

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    opts = parse_arguments(sys.argv[1:] if argv is None else argv)
    name = opts.pop("config", "demo_own")
    if name not in CONFIGS:
        raise SystemExit(f"unknown --config {name!r}; the port has {sorted(CONFIGS)}")
    device = "cpu" if opts.pop("cpu", False) else "cuda"
    cfg = override_options(CONFIGS[name](), opts)
    coach = Coach(cfg, device=device)
    logging.getLogger(__name__).info("config %s on %s, output %s", name, device,
                                     coach.output_path)
    coach.load_dataset(["test"])
    coach.build_networks()
    coach.restore_checkpoint_if_needed()
    if cfg.nerf.get("render_video"):
        return coach.test_model_video()
    return coach.test_model(save_images=True, separate_save=bool(cfg.get("separate_save")))


if __name__ == "__main__":
    main()
