"""Shared inputs of the train_ibrnet tests (tests/test_torch_ibrnet.py,
tests/test_torch_ibrnet_step.py): synthetic IBRNet trees of the port's
`data/synth.py` at 128x64 (attn_splits 4 needs the height in multiples of
32) and at the recipe's 1008x756, and configs/train_ibrnet.yaml as the JAX
package resolves it, cut for the CPU."""
import pytest

from matchnerf_tpu import config as jconfig
from matchnerf_tpu.utils import DotDict as JDotDict
from matchnerf_tpu_torch.data import DATASETS, synth
from matchnerf_tpu_torch.data.loader import collate
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF
from matchnerf_tpu_torch.weights import state_dict_from_jax

H, W = 756, 1008
SMALL_WH = (128, 64)


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    """Two groups of one scene, 8 views each, at 128x64."""
    root = str(tmp_path_factory.mktemp("ibrnet_small"))
    synth.write_ibrnet_tree(root, *SMALL_WH)
    return root


@pytest.fixture(scope="module")
def full_sample(tmp_path_factory):
    """Training sample 0 of a one-scene tree at 1008x756, as a batch."""
    root = str(tmp_path_factory.mktemp("ibrnet_full"))
    synth.write_ibrnet_tree(root, W, H, scenes=("ibrnet_collected_1/scene0",))
    return collate([DATASETS["ibrnet"](root, "train", img_wh=(W, H))[0]])


def jax_cfg(**nerf):
    """configs/train_ibrnet.yaml as the JAX package resolves it, cut to 1
    transformer layer under the f32 policy and the xla attention backend,
    with `nerf` overrides."""
    cfg = jconfig.build_options(JDotDict(yaml="train_ibrnet"))
    cfg.encoder.num_transformer_layers = 1
    cfg.encoder.attention_backend = "xla"
    cfg.encoder.pretrain_weight = None
    cfg.precision.encoder_compute_dtype = "float32"
    cfg.precision.decoder_compute_dtype = "float32"
    for k, v in nerf.items():
        setattr(cfg.nerf, k, v)
    return cfg


def port_model(cfg, params):
    """The port's model with the JAX params (through the weight bridge)."""
    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model
