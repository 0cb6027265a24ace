"""matchnerf_tpu_torch: the PyTorch + CUDA port of matchnerf_tpu.

The module tree mirrors `matchnerf_tpu/` (camera, ops, models/gmflow,
models/decoder, models/matchnerf, renderer) so each function has an obvious
JAX counterpart, and public functions keep the JAX package's array layouts
([B,P,2,h,w,C] encoder outputs, [V,B,R,S,2] sampling grids, ...). Inside, it
is ordinary PyTorch: `nn.Module`s whose `state_dict` keys are the reference
checkpoint's names, functions on tensors with an explicit device, and
explicit `torch.Generator`s.

Hand-written CUDA kernels (`csrc/`, built by `kernels.py` on first use)
replace every Pallas kernel of the JAX package:

- `ops/window_attention.py`  <- ops/pallas_attention.py::flash_window_attention,
                                ops/pallas_window_attention.py::fused_window_attention
- `ops/cosine_prior.py`      <- ops/pallas_banded.py::banded_cosine_scale(_trainable)
- `ops/decoder.py`           <- ops/pallas_decoder.py::cond_nerf_decode
- `ops/block_cosine_prior.py` <- ops/pallas_block_banded.py::block_banded_cosine_scale,
                                ::block_banded_cosine_scale_trainable
- `ops/supercell_color.py`   <- ops/pallas_color.py::supercell_color_sample
- `ops/fused_cosine.py`      <- ops/pallas_cond.py::fused_interp_grouped_cosine

Each keeps a plain PyTorch version beside it; a CPU tensor takes the plain
version, a CUDA tensor the kernel. The package never imports jax, yaml or PIL:
images decode and resize in a small host library, `csrc/image_io.cpp`
(built by `hostio.py` with the host C++ compiler; `data/jpeg.py`,
`data/resample.py`), bit-equal to PIL.
"""

__version__ = "0.1.0"
