"""Kernel E: per-sample bilinear source colours from a table of 4x4-pixel
supercells.

Replaces matchnerf_tpu/ops/pallas_color.py::supercell_color_sample (the eval
render's supercell colour Pallas kernel). The CUDA source is
csrc/supercell_color.cu; `supercell_color_sample_plain` is the same function
in plain PyTorch.

The table (`build_supercell_colors`) holds one row per 4x4 supercell: its
5x5 pixel window (every bilinear tap of every sample that falls in the
supercell, the +1 taps included), edge-padded past the image border, uint8
RGB in the layout ch = a*16 + b*3 + c (window row a, column b, colour c;
slot 15 of each window row is zero), 80 bytes a row. Each sample reads the
two window rows it needs from its own supercell's row and interpolates with
the clip-then-floor stencil of ops/grid_sample.py in the y-then-x
association of the TPU kernel (pallas_color.py:160-172). The TPU kernel
first gathers the union of supercells of each 8-ray block (to feed a
one-hot MXU product); the port needs no union, so it takes any grids, and
equals the union route wherever the union fits its bucket. Output [R,S,3V]
f32 on the 0-255 scale, channel 3v+c: the layout of the decoder's colour
input; the caller applies the 1/255 dequantisation, as the JAX package does.

`build_supercell_colors`, `supercell_cells_weights`, `color_union_size` and
`bucket_color_ut` are the counterparts of pallas_color.py's helpers; the
union size and its bucket only decide the route (`Renderer.pose_prep`), as
in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .block_cosine_prior import BLOCK_RAYS, first_of_runs
from .cosine_prior import VIEWS
from .grid_sample import bilinear_taps

COUNTER = kernels.LaunchCounter(
    "supercell_color", source="matchnerf_tpu_torch/csrc/supercell_color.cu",
    replaces="matchnerf_tpu/ops/pallas_color.py:177")

SC = 4                                   # supercell edge, in pixels
WIN = SC + 1                             # window edge (covers +1 taps)
ROW_CH = 16 * WIN                        # padded channels per table row
COLOR_UT_BUCKETS = (48, 64, 96, 128, 160, 192, 256, 320)
MAX_VIEWS = VIEWS[-1]                    # views the kernel takes: 1 to 16 (csrc/views.cuh)


def bucket_color_ut(n: int) -> Optional[int]:
    """A measured supercell-union size rounded up to its bucket; None when
    it overflows (pallas_color.py:58)."""
    for b in COLOR_UT_BUCKETS:
        if n <= b:
            return b
    return None


def supercell_grid(img_h: int, img_w: int):
    """(Hs, Ws): supercells per column and per row."""
    return -(-img_h // SC), -(-img_w // SC)


def build_supercell_colors(images_u8: torch.Tensor) -> torch.Tensor:
    """images_u8 [N,H,W,3] uint8 -> [N,Hs,Ws,ROW_CH] uint8 supercell table
    (pallas_color.py:65): row (sy, sx) holds the WINxWIN window at
    (SC*sy, SC*sx), edge-padded past the border."""
    N, H, W, _ = images_u8.shape
    Hs, Ws = supercell_grid(H, W)
    dev = images_u8.device
    ry = torch.clamp_max(torch.arange(Hs * SC + WIN - SC, device=dev), H - 1)
    rx = torch.clamp_max(torch.arange(Ws * SC + WIN - SC, device=dev), W - 1)
    img = images_u8[:, ry][:, :, rx]                     # edge padding
    zero = torch.zeros(N, Hs, Ws, 1, dtype=images_u8.dtype, device=dev)
    rows = []
    for a in range(WIN):
        cols = [img[:, a:a + SC * Hs:SC, b:b + SC * Ws:SC, :] for b in range(WIN)]
        rows.append(torch.cat(cols + [zero], dim=-1))    # [N,Hs,Ws,16]
    return torch.cat(rows, dim=-1).contiguous()          # [N,Hs,Ws,80]


def supercell_cells_weights(grid, img_h: int, img_w: int):
    """grid [...,2] -> (cell [...] int32 supercell, ty, tx [...] int32 in
    [0, SC), fy, fx [...] f32): the sample's supercell and its in-window tap
    (pallas_color.py:87)."""
    _, Ws = supercell_grid(img_h, img_w)
    (y0, x0, _, _), (_, _, fy, fx) = bilinear_taps(grid, img_h, img_w)
    sy = torch.div(y0, SC, rounding_mode="floor")
    sx = torch.div(x0, SC, rounding_mode="floor")
    return ((sy * Ws + sx).to(torch.int32), (y0 - sy * SC).to(torch.int32),
            (x0 - sx * SC).to(torch.int32), fy, fx)


def color_union_max(grids_v, img_h: int, img_w: int, block_rays: int = BLOCK_RAYS):
    """`color_union_size` as a 0-d device tensor (no host sync)."""
    cell = supercell_cells_weights(grids_v, img_h, img_w)[0]
    Hs, Ws = supercell_grid(img_h, img_w)
    blk = torch.sort(cell.reshape(-1, block_rays * cell.shape[-1]), dim=-1).values
    return first_of_runs(blk, Hs * Ws).sum(dim=-1).max()


def color_union_size(grids_v, img_h: int, img_w: int,
                     block_rays: int = BLOCK_RAYS) -> int:
    """Max over blocks of the sorted-unique supercell count (no dilation)
    (pallas_color.py:105). grids_v [R,S,2] or [V,R,S,2]."""
    return int(color_union_max(grids_v, img_h, img_w, block_rays))


def supercell_color_sample_plain(colors_sc, grids, img_h: int, img_w: int):
    """colors_sc [V,Hs,Ws,80] uint8; grids [V,R,S,2] f32; img_h, img_w the
    true image size -> [R,S,3V] f32 on the 0-255 scale.

    One view at a time: gather each sample's 80-byte supercell row, take its
    window rows ty, ty+1 blended by fy, then the columns tx, tx+1 blended
    by fx."""
    if colors_sc.is_cuda:
        COUNTER.plain_on_cuda += 1
    V, Hs, Ws, _ = colors_sc.shape
    R, S = grids.shape[1:3]
    cell, ty, tx, fy, fx = supercell_cells_weights(grids, img_h, img_w)
    rgb = torch.arange(3, device=colors_sc.device)
    out = []
    for v in range(V):
        win = colors_sc[v].reshape(Hs * Ws, WIN, 16)[cell[v].reshape(-1).long()]   # [N,5,16]
        tyv = ty[v].reshape(-1, 1, 1).long().expand(-1, 1, 16)
        fyv, fxv = fy[v].reshape(-1, 1), fx[v].reshape(-1, 1)
        t = (torch.gather(win, 1, tyv)[:, 0].float() * (1.0 - fyv)
             + torch.gather(win, 1, tyv + 1)[:, 0].float() * fyv)          # [N,16]
        col = tx[v].reshape(-1, 1).long() * 3 + rgb                          # [N,3]
        c = torch.gather(t, 1, col) * (1.0 - fxv) + torch.gather(t, 1, col + 3) * fxv
        out.append(c.reshape(R, S, 3))
    return torch.cat(out, dim=-1)


def supercell_color_sample(colors_sc, grids, img_h: int, img_w: int):
    """The kernel on CUDA tensors (V = 1 to 16 views), the plain version on
    CPU tensors. Another view count raises a ValueError that names V,
    before any launch."""
    if colors_sc.device.type == "cpu":
        return supercell_color_sample_plain(colors_sc, grids, img_h, img_w)
    V = colors_sc.shape[0] if colors_sc.dim() == 4 else None
    if V is None or not 1 <= V <= MAX_VIEWS:
        raise ValueError(f"supercell_color_sample: colors_sc {tuple(colors_sc.shape)} "
                         f"(V={V} views), the kernel takes V = 1 to {MAX_VIEWS} views")
    if not colors_sc.is_cuda:
        raise ValueError(f"supercell_color_sample: unsupported device {colors_sc.device}")
    Hs, Ws = colors_sc.shape[1:3]
    if (colors_sc.dtype != torch.uint8 or colors_sc.shape[-1] != ROW_CH
            or (Hs, Ws) != supercell_grid(img_h, img_w) or not colors_sc.is_contiguous()):
        raise ValueError(f"supercell_color_sample: colors_sc {tuple(colors_sc.shape)} "
                         f"{colors_sc.dtype}, kernel takes contiguous uint8 "
                         f"[V,{supercell_grid(img_h, img_w)},{ROW_CH}]")
    if (grids.dtype != torch.float32 or grids.dim() != 4 or grids.shape[0] != V
            or grids.shape[-1] != 2 or grids.device != colors_sc.device
            or not grids.is_contiguous()):
        raise ValueError(f"supercell_color_sample: grids {tuple(grids.shape)} "
                         f"{grids.dtype}, kernel takes contiguous f32 [{V},R,S,2]")
    R, S = grids.shape[1:3]
    out = torch.empty(R, S, 3 * V, dtype=torch.float32, device=colors_sc.device)
    if R * S == 0:
        return out
    kernels.launch(COUNTER, "supercell_color_u8", colors_sc.data_ptr(), grids.data_ptr(),
                   out.data_ptr(), V, Hs, Ws, img_h, img_w, R * S)
    return out
