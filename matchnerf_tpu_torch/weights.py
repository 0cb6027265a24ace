"""Weight bridge: JAX parameter pytree -> the port's state_dict; and the
GMFlow-pretrained encoder init (`load_gmflow_pretrained`).

The exact inverse of matchnerf_tpu/import_torch.py::import_matchnerf_checkpoint
(import_torch.py:190): linear weights [in,out] -> [out,in], convolutions
HWIO -> OIHW, LayerNorm scale/bias -> weight/bias, and the reference's
key names (`feat_enc.…`, `nerf_dec.…`, `alpha_linear.0`,
`out_alpha_linear.0/.2`, `mlp.0/.2`, `downsample.0`). Leaves may be numpy
arrays or anything `np.asarray` accepts (jax arrays included, without
importing jax here).

`load_gmflow_pretrained` is the port's counterpart of
import_torch.py:131 `import_gmflow_pretrained` (the reference's
misc/utils.py:160-180 filtering): a GMFlow flow checkpoint, "module."
prefixes stripped, without its flow upsampler (`upsampler.*`), its flow
refinement (`feature_flow_attn.*`) and the transformer layers past the
model's, loaded into the encoder's backbone and transformer; `featup_net`
keeps its seeded weights. The port's encoder has the reference's key
names, so the checkpoint's tensors load as they are.
"""
from __future__ import annotations

import re
from typing import Dict, Union

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _norm(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _encoder(sd, pre, p):
    bb = p["backbone"]
    _conv(sd, f"{pre}.backbone.conv1", bb["conv1"])
    _conv(sd, f"{pre}.backbone.conv2", bb["conv2"])
    for L in (1, 2, 3):
        for i, blk in enumerate(bb[f"layer{L}"]):
            bp = f"{pre}.backbone.layer{L}.{i}"
            _conv(sd, f"{bp}.conv1", blk["conv1"])
            _conv(sd, f"{bp}.conv2", blk["conv2"])
            if "downsample" in blk:
                _conv(sd, f"{bp}.downsample.0", blk["downsample"])
    for i, layer in enumerate(p["transformer"]["layers"]):
        for name in ("self_attn", "cross_attn_ffn"):
            lp = layer[name]
            ap = f"{pre}.transformer.layers.{i}.{name}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                _linear(sd, f"{ap}.{proj}", lp[proj])
            _norm(sd, f"{ap}.norm1", lp["norm1"])
            if "mlp" in lp:
                _linear(sd, f"{ap}.mlp.0", lp["mlp"]["w1"])
                _linear(sd, f"{ap}.mlp.2", lp["mlp"]["w2"])
                _norm(sd, f"{ap}.norm2", lp["norm2"])
    if "featup_net" in p:
        for name in ("conv_ls", "conv_l2rs"):
            for i, cp in enumerate(p["featup_net"][name]):
                _conv(sd, f"{pre}.featup_net.{name}.{i}", cp)


def _decoder(sd, pre, p):
    for i, lp in enumerate(p["pts_linears"]):
        _linear(sd, f"{pre}.pts_linears.{i}", lp)
    _linear(sd, f"{pre}.pts_bias", p["pts_bias"])
    _linear(sd, f"{pre}.views_linears.0", p["views_linears"][0])
    _linear(sd, f"{pre}.alpha_linear.0", p["alpha_linear"])
    ra = p["ray_attention"]
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        _linear(sd, f"{pre}.ray_attention.{name}", ra[name])
    _norm(sd, f"{pre}.ray_attention.layer_norm", ra["layer_norm"])
    _linear(sd, f"{pre}.out_alpha_linear.0", p["out_alpha_linear"][0])
    _linear(sd, f"{pre}.out_alpha_linear.2", p["out_alpha_linear"][1])
    _linear(sd, f"{pre}.feature_linear", p["feature_linear"])
    _linear(sd, f"{pre}.rgb_linear", p["rgb_linear"])


def state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """{'feat_enc': ..., 'nerf_dec': ...} pytree -> MatchNeRF state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, "feat_enc", params["feat_enc"])
    _decoder(sd, "nerf_dec", params["nerf_dec"])
    return sd


def load_gmflow_pretrained(encoder: torch.nn.Module, path_or_sd: Union[str, Dict]):
    """Load a GMFlow checkpoint (a path to a `.pth` whose "model" entry, or
    whole content, is the state_dict; or the state_dict) into `encoder` (a
    `models.gmflow.gmflow.GMFlow`), in place: its backbone and its first
    len(encoder.transformer.layers) transformer layers; `featup_net` stays
    as it is. Raises KeyError when the checkpoint lacks a tensor of the
    backbone or of those layers."""
    sd = path_or_sd
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    n_layers = len(encoder.transformer.layers)
    layer = re.compile(r"^transformer\.layers\.(\d+)\.")
    state = {}
    for key, value in sd.items():
        key = re.sub(r"^module\.", "", key)
        m = layer.match(key)
        if key.startswith("backbone.") or (m and int(m.group(1)) < n_layers):
            state[key] = torch.as_tensor(value)
    missing, unexpected = encoder.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.startswith("featup_net.")]
    if missing or unexpected:
        raise KeyError(f"GMFlow checkpoint: missing {missing}, unexpected {unexpected}")
