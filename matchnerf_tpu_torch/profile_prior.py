"""Kernels B, D and F on the card, against another build of their sources.

    python -m matchnerf_tpu_torch.profile_prior [--against DIR] [--sass] [--phases]
        [--views 3,8,10,16] [--ptxas]
    python -m matchnerf_tpu_torch.profile_prior --backward [--against DIR] [--sass]
        [--views 3,8,10,12,16]
    python -m matchnerf_tpu_torch.profile_prior --fused [--against DIR]

Times the cosine prior of both feature scales at the DTU eval render's
shapes: the first 20480 rays (one render slice) and the first 4096 rays
(configs/train.yaml's validation slice) of chip_smoke.py's target pose
(640x512, S=128, the same cameras, without the raytraced images), with the
pose's own union buckets from `Renderer.pose_prep`, on random tables of the
eval shapes ([3,64,80,256] and [3,128,160,256]): Kernel B and Kernel D on
int8 tables with scales and on bf16 tables, and Kernel B on f32 tables at
1024 random pixels (the training forward). Each is the whole wrapper call,
timed with CUDA events over 20 calls after two warm-up calls, and held
against its plain twin (max |d|). The plain twin's torch union build
(`block_unions`, which Kernel D's wrappers called before the union moved
into the kernel) is timed on its own.

With `--against DIR`, the cosine_prior.cu and block_cosine_prior.cu of DIR
(for example another commit's, from `git archive REV
matchnerf_tpu_torch/csrc`; their C entries must take this tree's
arguments) are built into build/kernels/ with the same flags and timed in
the same process, in turns (other, this, this, other). With `--sass`,
`cuobjdump -sass` counts each prior kernel's instructions by opcode
(static counts: where one thread runs one sample's channels of every view
and chunk, as in Kernel B, a count is per sample and lane). With `--phases`, Kernel D is built once more with
-DKERNEL_D_PHASES (clock64 marks of thread 0; the kernel the port runs has
none) and prints the mean cycles per block of its union build, its staging
passes and its sample loops at the 20480-ray slice. With `--views`, the
same cases at each of those source-view counts (default 3): the pose's
sources spread over the same arc (`scene_poses(V)`), tables
[V,h,w,(V-1)128], and past V = 4 fewer rays (`view_rays`: the plain twins'
f32 samples at their V = 4 size; 4384 at V = 8, 1024 at V = 16); Kernel D
only at a bucket its shared memory takes at V (`takes_table`), and each
case's output compared bit for bit with DIR's build where it takes V (a
build of V = 2 to 8 refuses 9 to 16; DIR's D is called in the layout that
holds every view's taps, and refuses a bucket that layout does not fit).
Where the route runs that layout, Kernel D in the pair layout at the same
pass width is timed beside it ("pair") and compared bit for bit; where the
route runs the pair layout, "this" is the pair layout. With `--ptxas`,
nvcc's registers and spills for every kernel of block_cosine_prior.cu
first. Prints the card's name and power limit and, as its last line, one
JSON object with every number.

With `--backward` it times the training prior's table gradient instead,
at V = 3 and V = 8 source views (`--views`: others; past V = 10 on fewer
rays, `train_rays`) (the pose's cameras spread over the same arc): the B'
backward (`ops.cosine_prior.table_grad`: the count pass, the
records kernel `cosine_prior_bwd_f32`, the sort and the sum) on 1024 iid
rays of the pose (configs/train.yaml) and D''s backward
(`ops.block_cosine_prior.table_grad`) on 128 strips of 8 pixels
(configs/train_fast.yaml), S = 128 with stratified depths, on random f32
tables of the training shapes ([V,64,80,(V-1)128] at G = 2,
[V,128,160,(V-1)128] at G = 8), D' at the pose's union buckets at V = 3 and
at the strips' own bucket past V = 3 (where D' does not take it, training
takes B' and D' is not timed). Each is the whole backward call on a fresh
zeroed gradient, held to autograd through its plain twin (max |d| against
1e-5 of the largest gradient) and to its own second call (bit for bit),
then timed with CUDA events over 20 calls, in turns with `--against`. DIR
may hold the earlier atomic build (one launch that adds into a zeroed
gradient with float4 atomics, `ATOMIC_SIGNATURES`): it is called as it
was, its zeroing timed with it. A records build (one with the
count pass) is called through this tree's wrappers on its library, in the
layout that holds every view's taps, where that fits, and compared bit
for bit; where the route runs that layout, D''s backward in the pair layout
at the same pass width is timed and compared beside it ("pair"). Beside the times it counts, on the host,
what each design issues for these grids: one float4 add per (sample, view,
tap, 4 channels) without runs; B''s runs for walks of 32, 64 and 128
consecutive samples (the reuse factor is the quotient; at 64, its records:
one (V-1)128-channel row each, written and read once, in place of the
atomic build's (V-1)32 float4 atomics); D''s runs (a band of depths across
the block's 8 rays: its records now, one 128-bit compare-and-swap per 4
channels in the atomic build's shared d_acc), and the atomic build's float4
global atomics, one per (block, union row, 4 channels). `--sass` adds each
kernel's atomic instructions by full mnemonic.

With `--fused` it times Kernel F (`fused_interp_grouped_cosine`) instead,
at V = 2 to 8, 10 and 16 source views (`FUSED_VIEWS`) on random tap rows
of 8192 rays x 128 samples at V <= 4 and of one fused-route chunk beyond
(`fused_chunk_rays(V)` rays: 2456 at V = 5, 872 at V = 8, 544 at V = 10,
200 at V = 16; int8 values in -127..127 with per-(view,
channel) scales, bf16 and f32 normal values; weights uniform in [0, 1)) at
G = 2 and 8, each held against its plain twin (max |d|, the twin taken
2**18 samples at a time). With `--against DIR`, DIR's fused_cosine.cu is
built and, at each V its launcher takes (it returns an error for the
others), its output is compared with this tree's bit for bit and both are
timed in turns. F's bound is chip_smoke.py's (phase 19).
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

from . import kernels
from .profile_attention import card_line

H, W = 512, 640
DTU_NEAR_FAR = (2.125, 4.525)
SLICE_RAYS, VAL_RAYS, TRAIN_RAYS = 20480, 4096, 1024
FUSED_RAYS = 8192             # Kernel F's rays at V <= 4 (`--fused`)
FUSED_VIEWS = (2, 3, 4, 5, 6, 7, 8, 10, 16)    # `--fused`: the compiled V and two past them
ITERS = 20
SOURCES = ("cosine_prior.cu", "block_cosine_prior.cu")
OPCODES = ("I2F", "I2FP", "F2F", "PRMT", "SGXT", "SHF", "LOP3", "IMAD", "FFMA", "FMUL",
           "FADD", "LDG", "LDS", "STS", "LDGSTS", "BAR", "SHFL")


def build_lib(sources, name: str, include: Path, flags=()) -> ctypes.CDLL:
    """Build `sources` into build/kernels/<name>.so with the port's flags
    (and `flags`), their headers from `include`."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / f"{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", str(include), "-shared",
           "-o", str(out), *(str(s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {sources}:\n{proc.stderr[-8000:]}")
    return ctypes.CDLL(str(out))


def bind(lib):
    for name, sig in kernels.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = sig
            fn.restype = ctypes.c_int
    return lib


def ptxas_report() -> list:
    """(kernel with its template arguments, registers, spill stores, spill
    loads) per kernel of this tree's block_cosine_prior.cu. The arguments
    as mangled: I a = int8, t = bf16 bits, f = f32 table; Li64 CP 64 (the
    backward: CPL, BL); Lb1 the flags (forward: WIDE, PAIR; backward and
    count pass: PAIR)."""
    obj = kernels.BUILD_DIR / "block_cosine_prior_ptxas.o"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
           str(kernels.CSRC_DIR / SOURCES[1])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-8000:]}")
    rows, name, spill = [], None, (0, 0)
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?\d(block_cosine_prior\w*?_kernel)(I\w*?E)Ev",
                      line)
        if m:
            name = m.group(1) + m.group(2)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


def sass_counts(lib_path: str) -> dict:
    """{kernel function: {opcode: count}} for the cosine-prior kernels, and
    under "atomics" each atomic instruction's full mnemonic (ATOMS.CAST.SPIN
    is a compare-and-swap loop's, RED.E.ADD.F32x4 a float4 reduction's)."""
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", lib_path], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed:\n{proc.stderr[-4000:]}")
    counts, fn = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "cosine_prior" in m.group(1) else None
            if fn:
                counts[fn] = collections.Counter()
                counts[fn]["atomics"] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)",
                     line)
        if fn and m:
            counts[fn][m.group(1)] += 1
            counts[fn]["total"] += 1
            if m.group(1).startswith(("ATOM", "RED")):
                counts[fn]["atomics"][m.group(1) + m.group(2)] += 1
    return {k: {**{op: v[op] for op in (*OPCODES, "total")}, "atomics": dict(v["atomics"])}
            for k, v in counts.items()}


def d_phases(torch, kd, cases, block_ut) -> list:
    """Kernel D built with -DKERNEL_D_PHASES: thread 0's mean cycles per
    block in the union build, the staging passes (with the wait for the
    block's slowest warp) and its own sample loops, one call per case."""
    lib = build_lib([kernels.CSRC_DIR / SOURCES[1]], "libprior_phases", kernels.CSRC_DIR,
                    ["-DKERNEL_D_PHASES"])
    bind(lib)
    lib.block_cosine_prior_phases.argtypes = [ctypes.c_void_p]
    lib.block_cosine_prior_phases.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 4)()
    saved, kernels._lib = kernels._lib, lib
    rows = []
    try:
        for _, dt, s, R, table, g, scales, G in cases:
            kd.block_cosine_prior(table, g, scales, G, block_ut[s])
            torch.cuda.synchronize()
            lib.block_cosine_prior_phases(counts)       # zero after the warm call
            kd.block_cosine_prior(table, g, scales, G, block_ut[s])
            torch.cuda.synchronize()
            if lib.block_cosine_prior_phases(counts) != 0:
                raise RuntimeError("block_cosine_prior_phases failed")
            blocks = counts[3]
            per = [counts[k] / blocks for k in range(3)]
            rows.append({"dtype": dt, "scale": s, "R": R, "blocks": blocks,
                         "union_build": per[0], "staging": per[1], "samples": per[2]})
            print(f"D {dt} scale {s} R={R} phases, cycles per block (thread 0): union "
                  f"build {per[0]:.0f}, staging {per[1]:.0f}, sample loops {per[2]:.0f} "
                  f"({blocks} blocks)", flush=True)
    finally:
        kernels._lib = saved
    return rows


def scene_poses(n_views: int = 3):
    """chip_smoke.py's cameras (seed 0): 3 source views and the target; with
    n_views, that many sources spread over the same arc."""
    from .data.synth import look_at_opencv
    rng = np.random.default_rng(0)
    angles = (np.deg2rad(list(np.linspace(-16.0, 16.0, n_views)) + [8.0])
              + rng.uniform(-0.02, 0.02, n_views + 1))
    w2cs = []
    for a in angles:
        c2w = np.eye(4)
        c2w[:3] = look_at_opencv((3.7 * math.sin(a), -1.0, -3.7 * math.cos(a)),
                                 (0.0, 0.1, 0.0))
        w2cs.append(np.linalg.inv(c2w).astype(np.float32))
    w2cs = np.stack(w2cs)[None]
    focal = 1.8 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    intr = np.tile(K, (1, n_views + 1, 1, 1))
    nf = np.tile(np.asarray(DTU_NEAR_FAR, np.float32), (1, n_views + 1, 1))
    return {"tgt": {"extrinsics": w2cs[:, -1, :3], "intrinsics": intr[:, -1],
                    "near_fars": nf[:, -1]},
            "ref": {"extrinsics": w2cs[:, :-1, :3], "intrinsics": intr[:, :-1],
                    "near_fars": nf[:, :-1]}}


def view_rays(R: int, V: int) -> int:
    """R rays to V = 4, then fewer in multiples of 8, so that the plain
    twins' f32 samples (R x S x V(V-1) x 128 floats) stay at their V = 4
    size (chip_smoke.py's `views_rays` for the 20480-ray slice)."""
    return min(R, 8 * (R * 12 // (V * (V - 1)) // 8))


def scene_grids(torch, dev, n_views: int = 3):
    """The target pose of chip_smoke.py's scene (`scene_poses(n_views)`):
    its eval grids [V,R,S,2] for the first SLICE_RAYS rays, grids at
    TRAIN_RAYS random pixels, and the pose's union buckets per feature
    scale."""
    from . import camera
    from .config import dtu_eval_config
    from .models.matchnerf import project_to_views, sample_depth
    from .renderer import Renderer
    poses = scene_poses(n_views)
    cfg = dtu_eval_config()
    cfg.n_src_views = n_views
    r = Renderer(cfg, None, dev)
    block_ut, _ = r.pose_prep(poses, [(H // 8, W // 8), (H // 4, W // 4)], H, W)
    tgt_intr, c2w, tgt_nf, ref_w2c, ref_intr, ref_nf = r._pose_tensors(poses)

    def grids_at(pix):
        center, ray = camera.get_center_and_ray(pix[None], tgt_intr, c2w)
        depth = sample_depth(cfg, tgt_nf, 1, pix.shape[0])
        pts = camera.get_3d_points_from_depth(center, ray, depth, multi_samples=True)
        return (project_to_views(pts, ref_w2c, ref_intr, ref_nf, H, W)[..., :2]
                * 2.0 - 1.0)[:, 0].contiguous()

    pix = camera.pixel_grid(H, W, legacy=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    train_pix = pix[torch.randperm(H * W, generator=gen, device=dev)[:TRAIN_RAYS]]
    return grids_at(pix[:SLICE_RAYS]), grids_at(train_pix), block_ut


def train_grids(torch, dev, patches: bool, seed: int, n_views: int = 3, R: int = TRAIN_RAYS):
    """Grids [V,R,128,2] of configs/train.yaml's training rays at the pose
    of `scene_grids` (its cameras, 640x512; `scene_poses(n_views)`): R
    (1024) iid pixels, or with `patches` R/8 strips of 8 pixels
    (train_fast.yaml); stratified depths as `TrainStep` draws them."""
    from . import camera
    from .config import dtu_train_config
    from .models.matchnerf import project_to_views, sample_depth
    from .renderer import Renderer
    from .train_step import sample_ray_indices
    cfg = dtu_train_config()
    r = Renderer(cfg, None, dev)
    tgt_intr, c2w, tgt_nf, ref_w2c, ref_intr, ref_nf = r._pose_tensors(scene_poses(n_views))
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = sample_ray_indices(H * W, R, patches, dev, gen)
    pix = torch.stack([(idx % W).float(), (idx // W).float()], -1)[None]
    center, ray = camera.get_center_and_ray(pix, tgt_intr, c2w)
    depth = sample_depth(cfg, tgt_nf, 1, R, stratified=True, generator=gen)
    pts = camera.get_3d_points_from_depth(center, ray, depth, multi_samples=True)
    return (project_to_views(pts, ref_w2c, ref_intr, ref_nf, H, W)[..., :2]
            * 2.0 - 1.0)[:, 0].contiguous()


def slot_cells(torch, grids, h: int, w: int):
    """grids [V,R,S,2] -> the cell each of a sample's four parity slots holds
    (slot (py, px) holds the footprint cell whose row and column have those
    parities; a 2x2 footprint has one cell of each): (keys [V,R,S,4], unique
    over the table widened by one row and column, real [V,R,S,4], False
    where the cell lies past the border (a clamped tap, weight 0), and the
    clamped cell y*w + x [V,R,S,4])."""
    from .ops.grid_sample import bilinear_taps
    (y0, x0, _, _), _ = bilinear_taps(grids, h, w)
    keys, real, cells = [], [], []
    for py in (0, 1):
        for px in (0, 1):
            y = y0 + ((y0 & 1) ^ py)
            x = x0 + ((x0 & 1) ^ px)
            keys.append(y * (w + 1) + x)
            real.append((y < h) & (x < w))
            cells.append(torch.clamp_max(y, h - 1) * w + torch.clamp_max(x, w - 1))
    return torch.stack(keys, -1), torch.stack(real, -1), torch.stack(cells, -1)


def run_starts(torch, keys, live, order, first) -> int:
    """Slots a walk flushes: keys, live [M, 4] per sample (flat index);
    `order` [K] the samples in walk order, `first` [K] True where a walk
    starts. A slot flushes once per run of consecutive walk samples that
    keep its cell, where the cell is live."""
    k, lv = keys[order], live[order]
    new = torch.ones_like(lv)
    new[1:] = k[1:] != k[:-1]
    new[first] = True
    return int((new & lv).sum())


def d_walks(cp: int) -> int:
    """D''s sample groups (walks) per block at CP channels a pass: 512
    threads, 8 lanes a group at CP 32, 16 at CP 64 and 128."""
    return 64 if cp == 32 else 32


def d_walk_order(torch, dev, R_pad: int, S: int, walks: int):
    """D''s walks: in each 8-ray block `walks` sample groups, group k on
    depths k * ceil(S / walks) onwards, each depth across the 8 rays,
    serpentine (even depths over rays 0..7, odd ones back). -> (order [K]
    flat sample indices, first [K])."""
    seg = -(-S // walks)
    order, first = [], []
    for k in range(walks):
        depths = torch.arange(k * seg, min(S, (k + 1) * seg), device=dev)
        if depths.numel() == 0:
            continue
        rays = torch.arange(8, device=dev)[None].expand(depths.numel(), 8).clone()
        rays[1::2] = rays[1::2].flip(-1)
        walk = (rays * S + depths[:, None]).reshape(-1)            # [seg * 8] in the block
        blocks = torch.arange(R_pad // 8, device=dev)[:, None] * (8 * S)
        order.append((blocks + walk[None]).reshape(-1))
        f = torch.zeros(R_pad // 8, walk.numel(), dtype=torch.bool, device=dev)
        f[:, 0] = True
        first.append(f.reshape(-1))
    return torch.cat(order), torch.cat(first)


def atomic_counts(torch, dev, grids_ray, grids_strip, h: int, w: int, ut: int,
                  cp: int) -> dict:
    """What B' and D''s backward issue for these grids, before and after
    their redesign (see the module's docstring)."""
    from .ops import block_cosine_prior as kd
    V, R, S = grids_ray.shape[:3]
    N = R * S
    q = (V - 1) * 32                     # float4 units of a view's table row
    keys, real, _ = slot_cells(torch, grids_ray, h, w)
    out = {"b_float4_per_tap": N * V * 4 * q}
    for walk in (32, 64, 128):
        n = torch.arange(N, device=dev)
        runs = sum(run_starts(torch, keys[v].reshape(N, 4), real[v].reshape(N, 4), n,
                              n % walk == 0) for v in range(V))
        out[f"b_float4_walk{walk}"] = runs * q
        if walk == 64:
            out["b_records"] = runs
    out["b_reuse"] = {k: out["b_float4_per_tap"] / v for k, v in out.items()
                      if k.startswith("b_float4_walk")}
    gp = kd.pad_rays(grids_strip)
    Rp = gp.shape[1]
    unions = kd.block_unions(gp, h, w, ut).view(V, Rp // 8, ut)
    keys, real, cells = slot_cells(torch, gp, h, w)
    order, first = d_walk_order(torch, dev, Rp, S, d_walks(cp))
    ray_ok = (torch.arange(Rp, device=dev) < R)[:, None, None].expand(Rp, S, 4)
    shared = 0
    for v in range(V):
        _, found = kd.union_positions(unions[v], cells[v].reshape(Rp // 8, 8 * S * 4), h * w)
        live = real[v] & found.reshape(Rp, S, 4) & ray_ok
        shared += run_starts(torch, keys[v].reshape(-1, 4), live.reshape(-1, 4), order, first)
    out["d_shared_f32_per_tap"] = N * V * 4 * (V - 1) * 128
    out["d_shared_f32_walks"] = shared * (V - 1) * 128
    out["d_reuse"] = out["d_shared_f32_per_tap"] / out["d_shared_f32_walks"]
    out["d_records"] = shared
    out["d_shared_cas128"] = shared * q
    out["d_global_float4"] = int((unions >= 0).sum()) * q
    return out


# the backward entries of the earlier atomic build, as DIR may hold them
ATOMIC_SIGNATURES = {
    # table, grids, g, d_table, V, H, W, C, G, N, stream
    "cosine_prior_bwd_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    # table, grids, unions, g, d_table, V, H, W, C, G, R, S, NB, ut, CP, stream
    "block_cosine_prior_bwd_f32": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
    + [ctypes.c_void_p]}


def bind_atomic(lib):
    """`lib` with its backward entries bound as the atomic build's, where it
    is one (it has no count pass); None otherwise."""
    if hasattr(lib, "cosine_prior_bwd_count"):
        return None
    for name, sig in ATOMIC_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return lib


def train_rays(V: int) -> int:
    """Rays of the backward cases at V views: TRAIN_RAYS to V = 10, then
    fewer (multiples of 8), so that the plain twins' f32 samples and their
    gradients stay at their V = 10 size (chip_smoke.py's
    `views_train_rays`: 696 at V = 12, 384 at V = 16)."""
    return min(TRAIN_RAYS, 8 * (TRAIN_RAYS * 90 // (V * (V - 1)) // 8))


def with_library(lib, fn):
    """fn() with `lib` as the port's kernel library (another build of its
    sources, called through this tree's wrappers)."""
    saved, kernels._lib = kernels._lib, lib
    try:
        return fn()
    finally:
        kernels._lib = saved


def backward(torch, dev, libs, block_ut, result, views=(3, 8)):
    """The B' and D' backward at the training shapes (see the module's
    docstring), this tree's and `libs`' in turns, at each of `views`."""
    from .ops import block_cosine_prior as kd
    from .ops import cosine_prior as kb
    atomic = {k: bind_atomic(lib) for k, lib in libs.items()}
    atomic = {k: lib for k, lib in atomic.items() if lib is not None}
    records = {k: lib for k, lib in libs.items() if k not in atomic}
    result["backward"] = []
    for V in views:
        R = train_rays(V)
        grids_ray = train_grids(torch, dev, False, 3, V, R)
        grids_strip = train_grids(torch, dev, True, 4, V, R)
        S = grids_ray.shape[2]
        N = R * S
        gen = torch.Generator(device=dev).manual_seed(5)
        for s, (h, w, G) in enumerate(((H // 8, W // 8, 2), (H // 4, W // 4, 8))):
            table = torch.randn(V, h, w, (V - 1) * 128, generator=gen, device=dev)
            gcot = torch.randn(R, S, G, generator=gen, device=dev)
            gp = kd.pad_rays(grids_strip)
            ut = (block_ut[s] if V == 3
                  else kd.bucket_ut(kd.block_union_size_raw(gp, h, w)))
            d_taken = ut is not None and kd.takes_f32(ut, S, G, h * w, V)
            how = kd.plan(ut, S, G, True, n_views=V) if d_taken else None
            cp = how.cp if d_taken else 32
            counts = atomic_counts(torch, dev, grids_ray, grids_strip, h, w,
                                   ut if d_taken else 64, cp)
            print(f"V={V} scale {s} {h}x{w} G={G} ut={ut} (D' {'takes' if d_taken else 'does not take'} it"
                  f"{', ' + str(how) if d_taken else ''}) runs and atomics: " + ", ".join(
                      f"{k} {v}" if not isinstance(v, float) else f"{k} {v:.3f}"
                      for k, v in counts.items()), flush=True)

            def plain_grad(fn, grids):
                t = table.clone().requires_grad_()
                fn(t, grids).backward(gcot)
                return t.grad

            cases = {"B'": (lambda: kb.table_grad(table, grids_ray, gcot, G),
                            "cosine_prior_bwd_f32",
                            lambda d: (table.data_ptr(), grids_ray.data_ptr(), gcot.data_ptr(),
                                       d.data_ptr(), V, h, w, 128, G, N),
                            plain_grad(lambda t, g: kb.cosine_prior_plain(t, g, None, G),
                                       grids_ray), {})}
            if d_taken:
                _, unions = kd._forward(table, grids_strip, None, G, ut, with_unions=True)
                grad = lambda layout=None: kd.table_grad(table, grids_strip, unions, gcot, G,
                                                         ut, layout=layout)
                extra = {}
                if not how.pair:              # the pair layout beside the route's
                    extra["pair"] = lambda: grad(kd.Plan(cp, True))
                held = kd.channels_per_pass(ut, S, G, True, n_views=V)
                for key, lib in records.items():
                    if held is not None:      # the layout a records build has
                        extra[key] = (lambda lib=lib: with_library(
                            lib, lambda: grad(kd.Plan(held, False))))
                cases["D'"] = (grad, "block_cosine_prior_bwd_f32",
                               lambda d: (table.data_ptr(), gp.data_ptr(), unions.data_ptr(),
                                          gcot.data_ptr(), d.data_ptr(), V, h, w, 128, G, R,
                                          S, gp.shape[1] // 8, ut, cp),
                               plain_grad(lambda t, g: kd.block_cosine_prior_plain(
                                   t, g, None, G, ut), grids_strip), extra)
            for kernel, (this_fn, entry, kargs, ref, extra) in cases.items():
                fns = {"this": this_fn, **({} if kernel == "B'" else extra)}
                if kernel == "B'":
                    fns.update({k: (lambda lib=lib: with_library(
                        lib, lambda: kb.table_grad(table, grids_ray, gcot, G)))
                        for k, lib in records.items()})
                for key, lib in atomic.items():
                    def atomic_call(lib=lib):
                        d = torch.zeros_like(table)
                        call(torch, lib, entry, *kargs(d))
                        return d
                    fns[key] = atomic_call
                errs, repeat, firsts = {}, {}, {}
                for key, fn in fns.items():
                    first, second = fn(), fn()
                    torch.cuda.synchronize()
                    errs[key] = float((first - ref).abs().max())
                    repeat[key] = bool(torch.equal(first, second))
                    firsts[key] = first
                    del second
                same = {k: bool(torch.equal(firsts[k], firsts["this"]))
                        for k in firsts if k != "this"}
                del firsts
                order = [k for k in fns if k != "this"] + ["this"]
                times = {k: [] for k in order}
                for k in order + order[::-1]:
                    times[k].append(events_ms(torch, fns[k]))
                tol = 1e-5 * float(ref.abs().max())
                line = f"{kernel} backward V={V} scale {s} R={R} S={S} G={G}"
                line += f" ut={ut} {how}: " if kernel == "D'" else ": "
                print(line + "; ".join(
                    f"{k} " + " / ".join(f"{t:.4f}" for t in ts)
                    + f" ms (max|d| {errs[k]:.2e}, tol {tol:.2e}, two calls "
                    + ("bit-equal" if repeat[k] else "differ")
                    + ("" if k == "this" else f", bit-equal to this {same[k]}") + ")"
                    for k, ts in times.items()), flush=True)
                result["backward"].append({"kernel": kernel, "V": V, "scale": s, "R": R,
                                           "S": S, "G": G, "ut": ut, "cp": cp,
                                           "layout": list(how) if kernel == "D'" else None,
                                           "ms": times, "max_abs_err": errs, "tol": tol,
                                           "bit_equal_twice": repeat,
                                           "bit_equal_to_this": same, "counts": counts})
                if errs["this"] > tol or not repeat["this"]:
                    raise AssertionError(f"{kernel} V={V} scale {s}: max|d| {errs['this']:.2e} "
                                         f"over {tol:.2e}, or two calls differ")
                if not all(v for k, v in same.items() if k not in atomic):
                    raise AssertionError(f"{kernel} V={V} scale {s}: another layout or build "
                                         f"gives other bits: {same}")
            del table, cases


def fused(torch, dev, against, result):
    """Kernel F at FUSED_VIEWS against its plain twin and, with `against`,
    against that directory's fused_cosine.cu (`--fused`)."""
    from .models.matchnerf import fused_chunk_rays
    from .ops import fused_cosine as kf
    other = None
    if against is not None:
        other = bind(build_lib([against / "fused_cosine.cu"], "libfused_against", against))
    gen = torch.Generator(device=dev).manual_seed(0)
    C = 128
    result["fused"] = []
    for V in FUSED_VIEWS:
        N = (FUSED_RAYS if V <= 4 else fused_chunk_rays(V)) * 128
        for dt in (torch.int8, torch.bfloat16, torch.float32):
            shape = (V, N, 4 * (V - 1) * C)
            if dt == torch.int8:
                rows = torch.randint(-127, 128, shape, generator=gen, device=dev,
                                     dtype=torch.int32).to(torch.int8)
                scales = torch.rand(V, (V - 1) * C, generator=gen, device=dev) * 0.02 + 1e-3
            else:
                rows = torch.randn(shape, generator=gen, device=dev, dtype=dt)
                scales = None
            wts = torch.rand(V, N, 2, generator=gen, device=dev)
            for G in (2, 8):
                fns = {"this": lambda: kf.fused_interp_grouped_cosine(rows, wts, G, scales)}
                out = fns["this"]()
                err = float((out - kf.fused_interp_grouped_cosine_plain(
                    rows, wts, G, scales, piece=2 ** 18)).abs().max())
                case = {"V": V, "dtype": str(dt).replace("torch.", ""), "G": G, "N": N,
                        "max_abs_err": err}
                if other is not None:
                    o_out = torch.empty_like(out)

                    def that():
                        call(torch, other, kf._KERNELS[dt], rows.data_ptr(), wts.data_ptr(),
                             kernels.ptr(scales), o_out.data_ptr(), V, C, G, N)
                        return o_out
                    try:
                        that()
                        torch.cuda.synchronize()
                        fns["other"] = that
                        case["bit_equal_to_other"] = bool(torch.equal(o_out, out))
                    except RuntimeError:
                        case["bit_equal_to_other"] = None       # the other refuses V
                order = [k for k in ("other", "this") if k in fns]
                case["ms"] = {k: [] for k in order}
                for k in order + order[::-1]:
                    case["ms"][k].append(events_ms(torch, fns[k]))
                print(f"F V={V} {case['dtype']} G={G} N={N}: max|d| vs plain {err:.3e}; "
                      + "; ".join(f"{k} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                                  for k, ts in case["ms"].items())
                      + (f"; bit-equal to the other build {case['bit_equal_to_other']}"
                         if other is not None else ""), flush=True)
                if not err <= 1e-5:
                    raise AssertionError(f"F V={V} {case['dtype']} G={G}: max|d| {err}")
                result["fused"].append(case)
                del out
            del rows, wts, scales
            torch.cuda.empty_cache()


def events_ms(torch, fn):
    """Mean milliseconds per call: CUDA events over ITERS calls after two
    warm-up calls."""
    for _ in range(2):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(ITERS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / ITERS


def call(torch, lib, name, *a):
    """One C launcher of `lib` on the current stream; raise on a CUDA error."""
    err = getattr(lib, name)(*a, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="a directory holding another cosine_prior.cu and "
                         "block_cosine_prior.cu to time beside this tree's")
    ap.add_argument("--sass", action="store_true", help="count the kernels' SASS opcodes")
    ap.add_argument("--phases", action="store_true",
                    help="Kernel D's cycles per block in its union build, staging and "
                         "sample loops (a build with -DKERNEL_D_PHASES)")
    ap.add_argument("--backward", action="store_true",
                    help="time B' and D''s backward kernels at the training shapes "
                         "instead, with their atomic counts")
    ap.add_argument("--fused", action="store_true",
                    help="time Kernel F at V = 2 to 8, 10 and 16 instead (--against: "
                         "DIR's fused_cosine.cu, compared bit for bit)")
    ap.add_argument("--views", default=None,
                    help="source-view counts of the B and D cases, comma-separated "
                         "(default 3; with --backward 3,8)")
    ap.add_argument("--ptxas", action="store_true",
                    help="nvcc's registers and spills for block_cosine_prior.cu's kernels")
    args = ap.parse_args(argv)
    import torch

    from .ops import block_cosine_prior as kd
    from .ops import cosine_prior as kb

    if not torch.cuda.is_available():
        raise SystemExit("profile_prior: needs a CUDA device")
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    result = {"card": card}
    this_lib = kernels.library()
    if args.fused:
        fused(torch, dev, args.against, result)
        print(card_line(), flush=True)
        print(json.dumps(result), flush=True)
        return 0
    libs = {}
    if args.against is not None:
        libs["other"] = bind(build_lib([args.against / s for s in SOURCES],
                                       "libprior_against", args.against))
    if args.sass:
        result["sass"] = {"this": sass_counts(this_lib._name)}
        for key, lib in libs.items():
            result["sass"][key] = sass_counts(lib._name)
        for key, per_fn in result["sass"].items():
            for fn, c in per_fn.items():
                print(f"sass {key} {fn}: " + ", ".join(f"{op} {n}" for op, n in c.items()
                                                       if n), flush=True)

    def b_lib(lib, table, grids, scales, G):
        V, h, w, _ = table.shape
        R, S = grids.shape[1:3]
        out = torch.empty(R, S, G, device=dev)
        call(torch, lib, kb.ENTRIES[table.dtype], table.data_ptr(), grids.data_ptr(),
             kernels.ptr(scales), out.data_ptr(), V, h, w, 128, G, R * S)
        return out

    def d_lib(lib, table, grids, scales, G, ut):
        """Another source's Kernel D, called as its wrapper calls it, in the
        layout that holds every view's taps (RuntimeError where that does
        not fit)."""
        V, h, w, _ = table.shape
        R, S = grids.shape[1:3]
        cp = kd.channels_per_pass(ut, S, G, False, 2, h * w, V)   # rows staged as bf16
        if cp is None:
            raise RuntimeError("the layout that holds every view's taps does not fit")
        out = torch.empty(R, S, G, device=dev)
        call(torch, lib, kd.ENTRIES[table.dtype], table.data_ptr(), grids.data_ptr(),
             kernels.ptr(scales), None, out.data_ptr(), V, h, w, 128, G, R, S, ut, cp)
        return out

    if args.ptxas:
        result["ptxas"] = ptxas_report()
        for row in result["ptxas"]:
            print("ptxas %-58s %3d registers, spill stores %d B, loads %d B" % row, flush=True)
    views = [int(v) for v in (args.views or ("3,8" if args.backward else "3")).split(",")]
    if args.backward:
        _, _, block_ut = scene_grids(torch, dev)
        print(f"pose buckets {block_ut}", flush=True)
        result["block_ut"] = list(block_ut)
        backward(torch, dev, libs, block_ut, result, views)
        print(card_line(), flush=True)
        print(json.dumps(result), flush=True)
        return 0
    gen = torch.Generator(device=dev).manual_seed(2)
    result["cases"], result["block_ut"] = [], {}
    fmt = lambda xs: " / ".join(f"{x:.4f}" for x in xs)
    phase_cases = []
    for V in views:
        grids_all, grids_train, block_ut = scene_grids(torch, dev, V)
        print(f"V={V} pose buckets {block_ut}", flush=True)
        result["block_ut"][V] = list(block_ut)
        cases = []
        Cc = (V - 1) * 128
        for s, (h, w, G) in enumerate(((H // 8, W // 8, 2), (H // 4, W // 4, 8))):
            q = torch.randint(-127, 128, (V, h, w, Cc), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int8)
            scales = torch.rand(V, Cc, generator=gen, device=dev) * 0.02 + 1e-3
            fb = torch.randn(V, h, w, Cc, generator=gen, device=dev)
            for R in sorted({view_rays(SLICE_RAYS, V), view_rays(VAL_RAYS, V)}, reverse=True):
                g = grids_all[:, :R].contiguous()
                cases.append(("B", "int8", s, R, q, g, scales, G))
                cases.append(("D", "int8", s, R, q, g, scales, G))
                cases.append(("B", "bf16", s, R, fb.to(torch.bfloat16), g, None, G))
                cases.append(("D", "bf16", s, R, fb.to(torch.bfloat16), g, None, G))
            cases.append(("B", "f32", s, TRAIN_RAYS, fb, grids_train, None, G))
        for kernel, dt, s, R, table, g, scales, G in cases:
            ut = block_ut[s]
            h, w = table.shape[1:3]
            line = f"{kernel} V={V} {dt} scale {s} R={R} G={G}"
            if kernel == "D" and (ut is None
                                  or not kd.takes_table(table, scales, ut, g.shape[2], G)):
                print(f"{line}: ut={ut}, Kernel D does not take it at V={V} (the route: "
                      "Kernel B)", flush=True)
                continue
            if kernel == "B":
                fns = {"this": lambda: kb.cosine_prior(table, g, scales, G)}
                fns.update({k: (lambda lib=lib: b_lib(lib, table, g, scales, G))
                            for k, lib in libs.items()})
                ref = kb.cosine_prior_plain(table, g, scales, G)
            else:
                how = kd.plan(ut, g.shape[2], G, False, 2, h * w, V)
                fns = {"this": lambda: kd.block_cosine_prior(table, g, scales, G, ut)}
                if "other" in libs:
                    fns["other"] = lambda: d_lib(libs["other"], table, g, scales, G, ut)
                if not how.pair:          # the pair layout at the route's pass width
                    fns["pair"] = lambda: kd._forward(table, g, scales, G, ut,
                                                      layout=kd.Plan(how.cp, True))[0]
                ref = kd.block_cosine_prior_plain(table, g, scales, G, ut)
            entry = {"kernel": kernel, "V": V, "dtype": dt, "scale": s, "R": R, "G": G}
            if kernel == "D":
                entry["layout"] = list(how)
            mine = fns["this"]()
            errs = {"this": float((mine - ref).abs().max())}
            for key in [k for k in ("other", "pair") if k in fns]:
                try:
                    theirs = fns[key]()
                    torch.cuda.synchronize()
                    errs[key] = float((theirs - ref).abs().max())
                    entry[f"bit_equal_to_{key}"] = bool(torch.equal(mine, theirs))
                except RuntimeError:
                    del fns[key]                      # the other build refuses V
                    entry[f"bit_equal_to_{key}"] = None
            order = [k for k in ("other", "pair", "this") if k in fns]
            times = {k: [] for k in order}
            for k in order + order[::-1]:
                times[k].append(events_ms(torch, fns[k]))
            entry.update(ms=times, max_abs_err=errs)
            if kernel == "D":
                gp = kd.pad_rays(g)
                entry["ut"] = ut
                entry["union_build_ms"] = events_ms(torch,
                                                    lambda: kd.block_unions(gp, h, w, ut))
                line += (f" ut={ut} {how}, the plain twin's union build "
                         f"{entry['union_build_ms']:.4f} ms")
            print(line + ": " + "; ".join(f"{k} {fmt(t)} ms (max|d| {errs[k]:.2e})"
                                          for k, t in times.items())
                  + "".join(f"; bit-equal to {k} {entry['bit_equal_to_' + k]}"
                            for k in ("other", "pair") if "bit_equal_to_" + k in entry),
                  flush=True)
            if entry.get("bit_equal_to_pair") is False:
                raise AssertionError(f"{line}: the pair layout gives other bits")
            result["cases"].append(entry)
            del ref, mine
        if V == 3:
            phase_cases = [(c, block_ut) for c in cases if c[0] == "D" and c[3] == SLICE_RAYS]
        del cases
        torch.cuda.empty_cache()
    if args.phases and phase_cases:
        result["phases"] = d_phases(torch, kd, [c for c, _ in phase_cases],
                                    phase_cases[0][1])
    print(card_line(), flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
