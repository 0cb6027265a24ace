"""Evaluation and video entry of the port (counterpart of test.py).

    python -m matchnerf_tpu_torch.test --config demo_own \\
        [--precision.fused_cosine=true] [--nerf.video_n_frames=N] \\
        [--load=PATH | --load=] [--output_root=DIR] [--cpu] [--key.sub=value ...]

`--config` names a configuration of `config.CONFIGS` (demo_own: the
COLMAP printer scene of configs/demo_own.yaml); every other `--key=value`
overrides it as the JAX entry's YAML overrides do (`--flag` is true,
`--flag!` false, `--key=` None: `--load=` keeps the seeded weights). With
`nerf.render_video` it renders the trajectory video (`Coach.test_model_video`),
otherwise the test views with their metrics (`Coach.test_model`), under
`<output_root>/<name>/`. It runs on the card unless given `--cpu`.
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
