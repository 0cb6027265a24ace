"""Kernel B (grouped-cosine matching prior) of the PyTorch port vs the JAX
package, on the CPU.

- The port's unpacked int8 tables equal the JAX `view_feats_unpacked` bit
  for bit (same abs-max / 127, round half to even, clip).
- The plain Kernel B matches `banded_cosine_scale` (Pallas, interpret mode)
  on f32 tables at atol 2e-5 (f32 one-hot matmul vs direct interpolation).
- On int8 tables it matches `banded_cosine_scale` at atol 1e-2, the bound
  tests/test_pallas_banded.py sets for that kernel's bf16 bilinear weights,
  and the JAX direct packed-gather path at atol 2e-5.
- On bf16 tables (configs/train.yaml's eval renders) the same: the JAX
  kernel at atol 1e-2 (it reaches it through `banded_cosine_scale_trainable`,
  whose forward is `banded_cosine_scale`), the direct path at atol 2e-5;
  the port's bf16 tables equal the JAX `view_feats_unpacked` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.models.gmflow.gmflow import pair_index_lists
from matchnerf_tpu.models.matchnerf import _grouped_cosine
from matchnerf_tpu.models.matchnerf import \
    prepare_sampling_tables as jax_prepare_tables
from matchnerf_tpu.ops.grid_sample import grid_sample_2d_packed, pack_2x2
from matchnerf_tpu.ops.pallas_banded import banded_cosine_scale, banded_cosine_scale_trainable
from matchnerf_tpu_torch.models.matchnerf import \
    prepare_sampling_tables as torch_prepare_tables
from matchnerf_tpu_torch.ops import cosine_prior as tcp
from torch_threads import one_torch_thread  # noqa: F401

V, H, W, C = 3, 24, 32, 16
R, S, G = 16, 32, 4


def _coherent_grids(rng):
    """Monotone straight segments per ray (epipolar-like), [V,R,S,2]."""
    starts = rng.uniform(-1.1, 0.3, (V, R, 2))
    ends = starts + rng.uniform(0.05, 0.6, (V, R, 2))
    t = np.linspace(0, 1, S)[None, None, :, None]
    return (starts[:, :, None, :] * (1 - t) + ends[:, :, None, :] * t).astype(np.float32)


def _packed(table):
    """[V,h,w,Cc] -> JAX pack_2x2 tables [1,V,h,w,4Cc]."""
    return jax.vmap(lambda f: pack_2x2(f[None])[0])(jnp.asarray(table))[None]


def _jax_direct(packed, grids, scales):
    sampled = []
    for v in range(V):
        s = grid_sample_2d_packed(packed[:, v], jnp.asarray(grids[v])[None]).astype(jnp.float32)
        if scales is not None:
            s = s * jnp.asarray(scales)[v][None, None, None, :]
        sampled.append(s)
    per_pair = []
    for (i, j) in pair_index_lists(V):
        fa = sampled[i][..., (j - 1) * C:j * C]
        fb = sampled[j][..., i * C:(i + 1) * C]
        per_pair.append(_grouped_cosine(fa, fb, G))
    return np.asarray(jnp.stack(per_pair, 0).mean(0))[0]


def test_int8_tables_bit_exact():
    cfg = ge._tiny_cfg(n_layers=1)
    rng = np.random.default_rng(0)
    feats = [rng.normal(0, 1.5, (1, 3, 2, h, w, 8)).astype(np.float32)
             for (h, w) in ((4, 6), (8, 12))]
    imgs = rng.uniform(-0.1, 1.1, (1, 3, 16, 24, 3)).astype(np.float32)
    ref = jax_prepare_tables(cfg, [jnp.asarray(f) for f in feats], jnp.asarray(imgs),
                             feat_dtype=jnp.int8, color_dtype=jnp.uint8,
                             keep_unpacked=True)
    got = torch_prepare_tables(cfg, [torch.tensor(f) for f in feats], torch.tensor(imgs),
                               feat_dtype=torch.int8, color_dtype=torch.uint8)
    for s in range(2):
        assert got["view_feats"][s].dtype == torch.int8
        np.testing.assert_array_equal(got["view_feats"][s].numpy(),
                                      np.asarray(ref["view_feats_unpacked"][s]))
        np.testing.assert_array_equal(got["view_feat_scales"][s].numpy(),
                                      np.asarray(ref["view_feat_scales"][s]))
    # the packed colour table's first tap block is the u8 image itself
    np.testing.assert_array_equal(got["colors"].numpy(),
                                  np.asarray(ref["colors"])[..., :3])
    assert got["color_scale"] == ref["color_scale"]


def test_plain_kernel_b_f32_matches_banded_kernel():
    rng = np.random.default_rng(1)
    table = rng.normal(0, 1, (V, H, W, 2 * C)).astype(np.float32)
    grids = _coherent_grids(rng)
    ref = banded_cosine_scale(_packed(table), jnp.asarray(grids)[:, None], kt=48,
                              n_groups=G, pairs=pair_index_lists(V))
    got = tcp.cosine_prior(torch.tensor(table), torch.tensor(grids), None, G)
    assert got.shape == (R, S, G)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0], atol=2e-5, rtol=1e-5)


def test_plain_kernel_b_int8_matches_banded_and_direct():
    rng = np.random.default_rng(2)
    feat = rng.normal(0, 1, (V, H, W, 2 * C)).astype(np.float32)
    scale = np.maximum(np.abs(feat).max(axis=(1, 2)), 1e-12) / 127.0     # [V,Cc]
    q = np.clip(np.round(feat / scale[:, None, None]), -127, 127).astype(np.int8)
    grids = _coherent_grids(rng)
    packed = _packed(q)
    ref_kernel = banded_cosine_scale(packed, jnp.asarray(grids)[:, None], kt=48,
                                     n_groups=G, pairs=pair_index_lists(V),
                                     dequant_scales=jnp.asarray(scale)[None])
    ref_direct = _jax_direct(packed, grids, scale)
    got = tcp.cosine_prior(torch.tensor(q), torch.tensor(grids),
                           torch.tensor(scale.astype(np.float32)), G).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_kernel)[0], atol=1e-2)
    np.testing.assert_allclose(got, ref_direct, atol=2e-5, rtol=1e-5)


def test_plain_kernel_b_bf16_matches_banded_and_direct():
    rng = np.random.default_rng(4)
    feat = rng.normal(0, 1, (V, H, W, 2 * C)).astype(np.float32)
    grids = _coherent_grids(rng)
    tb = torch.tensor(feat).to(torch.bfloat16)
    jb = jnp.asarray(feat).astype(jnp.bfloat16)
    np.testing.assert_array_equal(tb.view(torch.int16).numpy(),
                                  np.asarray(jb).view(np.int16))
    packed = _packed(jb)
    ref_kernel = banded_cosine_scale(packed, jnp.asarray(grids)[:, None], kt=48,
                                     n_groups=G, pairs=pair_index_lists(V))
    ref_direct = _jax_direct(packed, grids, None)
    got = tcp.cosine_prior(tb, torch.tensor(grids), None, G).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_kernel)[0], atol=1e-2)
    np.testing.assert_allclose(got, ref_direct, atol=2e-5, rtol=1e-5)


def test_bf16_tables_bit_exact():
    cfg = ge._tiny_cfg(n_layers=1)
    rng = np.random.default_rng(5)
    feats = [rng.normal(0, 1.5, (1, 3, 2, h, w, 8)).astype(np.float32)
             for (h, w) in ((4, 6), (8, 12))]
    imgs = rng.uniform(0, 1, (1, 3, 16, 24, 3)).astype(np.float32)
    ref = jax_prepare_tables(cfg, [jnp.asarray(f) for f in feats], jnp.asarray(imgs),
                             feat_dtype=jnp.bfloat16, keep_unpacked=True)
    got = torch_prepare_tables(cfg, [torch.tensor(f) for f in feats], torch.tensor(imgs),
                               feat_dtype=torch.bfloat16)
    for s in range(2):
        assert got["view_feats"][s].dtype == torch.bfloat16
        assert got["view_feat_scales"][s] is None and ref["view_feat_scales"][s] is None
        np.testing.assert_array_equal(got["view_feats"][s].view(torch.int16).numpy(),
                                      np.asarray(ref["view_feats_unpacked"][s]).view(np.int16))


@pytest.mark.parametrize("n_groups", [1, 8])
def test_grouped_cosine_matches_jax(n_groups):
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, (2, 5, 7, 16)).astype(np.float32)
    b = rng.normal(0, 1, (2, 5, 7, 16)).astype(np.float32)
    b[0, 0, 0] = 0.0                       # zero vector: the eps clamp engages
    ref = _grouped_cosine(jnp.asarray(a), jnp.asarray(b), n_groups)
    got = tcp.grouped_cosine(torch.tensor(a), torch.tensor(b), n_groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte n of the result is byte
    (s >> 4n) & 7 of the eight bytes of x (0-3) and y (4-7)."""
    xy = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(xy), np.uint64)
    for n in range(4):
        sel = np.uint64((s >> (4 * n)) & 7)
        out |= ((xy >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def int8x4_to_f32(words):
    """csrc/int8_exact.cuh's int8x4_to_f32 on uint32 words -> [n, 4] f32:
    each byte, sign bit flipped, into the low byte of 0x4B000000, minus
    8388736.0f, all in f32."""
    x = np.asarray(words, np.uint32) ^ np.uint32(0x80808080)
    return np.stack([byte_perm(x, 0x4B000000, 0x7650 + b).view(np.float32)
                     - np.float32(8388736.0) for b in range(4)], axis=-1)


def test_int8_integer_pipe_conversion_exact():
    """Kernels B and D convert int8 without an int-to-float instruction: a
    byte permute and an f32 subtract give every one of the 256 values
    exactly, and Kernel D's staging packs them as exact bf16 pairs."""
    vals = np.arange(-128, 128).astype(np.int8)
    words = vals.view(np.uint8).reshape(-1, 4).copy().view("<u4").ravel()
    got = int8x4_to_f32(words)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.ravel(), vals.astype(np.float32))
    bits = got.view(np.uint32)
    pairs = np.stack([byte_perm(bits[:, 0], bits[:, 1], 0x7632),
                      byte_perm(bits[:, 2], bits[:, 3], 0x7632)], axis=-1)   # bf16 x2
    halves = np.stack([pairs & 0xFFFF, pairs >> 16], axis=-1).astype(np.uint32)
    np.testing.assert_array_equal((halves << 16).view(np.float32).ravel(),
                                  vals.astype(np.float32))


@pytest.mark.parametrize("n_groups", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("cpl", [16, 8])
def test_kernel_b_lane_layout(n_groups, cpl):
    """Kernel B's reduction layout: 128/cpl lanes a sample (8 lanes of 16
    channels on int8 and bf16 rows, 16 of 8 on f32 rows), lane l owning
    channels cpl*l .. cpl*l+cpl-1 of a chunk with a partial sum per 8-channel
    half; the halves sum and the 128/G/cpl lanes of a group reduce by xor
    shuffles, the group's first lane writing it; at G = 16 with 16 channels
    a lane, each half is a group. Emulated in numpy, equal to the grouped
    cosine."""
    rng = np.random.default_rng(4)
    a = rng.normal(0, 1, (5, 128)).astype(np.float32)
    b = rng.normal(0, 1, (5, 128)).astype(np.float32)
    lanes = 128 // cpl
    part = lambda x, y: (x * y).reshape(5, lanes, cpl // 8, 8).sum(-1)   # [n, lane, half]
    dot, na2, nb2 = part(a, b), part(a, a), part(b, b)
    cos = lambda d, p, q: d / (np.maximum(np.sqrt(p), 1e-8) * np.maximum(np.sqrt(q), 1e-8))
    if cpl == 16 and n_groups == 16:
        got = cos(dot, na2, nb2).reshape(5, 16)
    else:
        lpg = 128 // n_groups // cpl
        d, p, q = (t.sum(-1) for t in (dot, na2, nb2))           # [n, lane]
        off = lpg // 2
        while off:
            swap = np.arange(lanes) ^ off
            d, p, q = d + d[:, swap], p + p[:, swap], q + q[:, swap]
            off //= 2
        got = cos(d, p, q)[:, ::lpg]
    ref = tcp.grouped_cosine(torch.tensor(a), torch.tensor(b), n_groups).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)


# ----------------------------------------------------------------- B' walks
PAIRS3 = pair_index_lists(3)


def _edge_grids(rng, R, S):
    """[V,R,S,2] rays of every kind B''s and D''s walks must handle: rays
    0-1 stay inside one cell (the longest run), 2-4 run along the right
    border, the bottom border and into the corner (clamped taps, where one
    cell takes two weights of one sample, one of them 0), 5-6 leave a cell
    and come back (a zigzag, not monotone), the rest straight segments."""
    t = np.linspace(0, 1, S)[None, :, None]
    starts = rng.uniform(-0.9, 0.3, (V, R, 1, 2))
    g = starts + rng.uniform(0.05, 0.6, (V, R, 1, 2)) * t[None]
    g[:, 0:2] = starts[:, 0:2] + rng.uniform(0, 1e-3, (V, 2, S, 2))
    g[:, 2, :, 0], g[:, 2, :, 1] = 1.0, np.linspace(-0.8, 0.7, S)
    g[:, 3, :, 0], g[:, 3, :, 1] = np.linspace(-0.5, 0.9, S), 1.3
    g[:, 4] = np.linspace(0.8, 1.2, S)[:, None]
    zig = np.abs(((np.arange(S) / 3.0) % 2.0) - 1.0)[None, :, None]
    g[:, 5:7] = starts[:, 5:7] + 0.4 * zig[None]
    return g.astype(np.float32)


def _slot_footprint(grid, h, w):
    """grid [M,2] -> (rows [M,4] clamped cells, keys [M,4] (-1 past the
    border), weights [M,4]) of the parity slots, in the kernels' f32
    arithmetic: slot 2*py + px holds the footprint cell whose row and column
    have parities (py, px)."""
    f = np.float32
    x = np.clip((grid[:, 0] + f(1)) * f(0.5) * f(w - 1), f(0), f(w - 1))
    y = np.clip((grid[:, 1] + f(1)) * f(0.5) * f(h - 1), f(0), f(h - 1))
    x0f, y0f = np.floor(x), np.floor(y)
    wx = (f(1) - (x - x0f), x - x0f)
    wy = (f(1) - (y - y0f), y - y0f)
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)
    rows, keys, wts = [], [], []
    for s in range(4):
        a, b = (s >> 1) ^ (y0 & 1), (s & 1) ^ (x0 & 1)
        yy, xx = y0 + a, x0 + b
        row = np.minimum(yy, h - 1) * w + np.minimum(xx, w - 1)
        rows.append(row)
        keys.append(np.where((yy < h) & (xx < w), row, -1))
        wts.append(np.where(a == 1, wy[1], wy[0]) * np.where(b == 1, wx[1], wx[0]))
    return np.stack(rows, 1), np.stack(keys, 1), np.stack(wts, 1)


def _cosine_bwd(fa, fb, dcos, n_groups, eps=1e-8):
    """pallas_banded.py::_grouped_cosine_bwd of one sample and pair: the
    gradients of both sides, none through a norm clamped at eps."""
    a, b = fa.reshape(n_groups, -1), fb.reshape(n_groups, -1)
    dot, na2, nb2 = (a * b).sum(-1), (a * a).sum(-1), (b * b).sum(-1)
    sna, snb = np.sqrt(na2), np.sqrt(nb2)
    na, nb = np.maximum(sna, eps), np.maximum(snb, eps)
    inv = 1.0 / (na * nb)
    d_dot = dcos * inv
    d_na2 = np.where(sna > eps, -dcos * dot * inv / na * (0.5 / na), 0.0)
    d_nb2 = np.where(snb > eps, -dcos * dot * inv / nb * (0.5 / nb), 0.0)
    return ((d_dot[:, None] * b + 2 * d_na2[:, None] * a).reshape(-1),
            (d_dot[:, None] * a + 2 * d_nb2[:, None] * b).reshape(-1))


def b_prime_walks(table, grids, g, n_groups, walk):
    """csrc/cosine_prior.cu's B' backward in numpy: per pair, walks of
    `walk` consecutive flat samples; each side's four parity slots sum
    their cell's gradient while the cell stays and add it to d_table when it
    changes and at the walk's end (never a cell past the border). ->
    (d_table [V,h,w,2C], the number of slot flushes)."""
    Vv, h, w, Cc = table.shape
    C = Cc // 2
    N = grids.shape[1] * grids.shape[2]
    rows = table.reshape(Vv, h * w, Cc).astype(np.float64)
    feet = [_slot_footprint(grids[v].reshape(N, 2), h, w) for v in range(Vv)]
    gg = g.reshape(N, n_groups).astype(np.float64)
    d = np.zeros_like(rows)
    flushes = 0
    for (i, j) in PAIRS3:
        sides = ((i, (j - 1) * C), (j, i * C))
        for w0 in range(0, N, walk):
            state = [([-1] * 4, np.zeros((4, C))) for _ in sides]
            for n in range(w0, min(N, w0 + walk)):
                f = [(feet[v][2][n][:, None] * rows[v, feet[v][0][n], c0:c0 + C]).sum(0)
                     for v, c0 in sides]
                dfs = _cosine_bwd(f[0], f[1], gg[n] / 3.0, n_groups)
                for (v, c0), (key, acc), df in zip(sides, state, dfs):
                    for s in range(4):
                        new, wt = feet[v][1][n][s], feet[v][2][n][s]
                        if new != key[s]:
                            if key[s] >= 0:
                                d[v, key[s], c0:c0 + C] += acc[s]
                                flushes += 1
                            key[s], acc[s] = new, wt * df
                        else:
                            acc[s] += wt * df
            for (v, c0), (key, acc) in zip(sides, state):
                for s in range(4):
                    if key[s] >= 0:
                        d[v, key[s], c0:c0 + C] += acc[s]
                        flushes += 1
    return d.reshape(table.shape), flushes


def _fold_packed_grad(gp, Cc):
    """The transpose of pack_2x2: JAX's packed table gradient [V,h,w,4Cc]
    folded onto the unpacked table [V,h,w,Cc]."""
    acc = gp[..., :Cc].copy()
    acc[:, :, 1:] += gp[:, :, :-1, Cc:2 * Cc]
    acc[:, :, -1] += gp[:, :, -1, Cc:2 * Cc]
    acc[:, 1:] += gp[:, :-1, :, 2 * Cc:3 * Cc]
    acc[:, -1] += gp[:, -1, :, 2 * Cc:3 * Cc]
    acc[:, 1:, 1:] += gp[:, :-1, :-1, 3 * Cc:]
    acc[:, 1:, -1] += gp[:, :-1, -1, 3 * Cc:]
    acc[:, -1, 1:] += gp[:, -1, :-1, 3 * Cc:]
    acc[:, -1, -1] += gp[:, -1, -1, 3 * Cc:]
    return acc


@pytest.mark.parametrize("n_groups,walk", [(1, 64), (2, 64), (4, 7), (8, 64), (16, 5)])
def test_b_prime_walks_match_plain_and_jax(n_groups, walk):
    """B''s walks (parity slots, a flush per run) give the plain twin's
    table gradient and the JAX custom VJP's on rays that stay in one cell,
    run along the borders, revisit a cell and cross walk boundaries (13
    rays x 24 samples: 312, not a multiple of the walk), and flush fewer
    rows than one per (sample, view, tap)."""
    rng = np.random.default_rng(21)
    h, w, Cc, Rr, Ss = 12, 14, 64, 13, 24        # 2 channels a group at G = 16
    feat = rng.normal(0, 1, (V, h, w, Cc)).astype(np.float32)
    grids = _edge_grids(rng, Rr, Ss)
    gcot = rng.normal(0, 1, (Rr, Ss, n_groups)).astype(np.float32)
    got, flushes = b_prime_walks(feat, grids, gcot, n_groups, walk)

    t = torch.tensor(feat, requires_grad=True)
    tcp.cosine_prior_plain(t, torch.tensor(grids), None, n_groups).backward(torch.tensor(gcot))
    ref = t.grad.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())

    jgrids = jnp.asarray(grids)[:, None]
    _, vjp = jax.vjp(lambda vf: banded_cosine_scale_trainable(vf, jgrids, 96, n_groups,
                                                              PAIRS3, 8), _packed(feat))
    (jg,) = vjp(jnp.asarray(gcot)[None])
    np.testing.assert_allclose(got, _fold_packed_grad(np.asarray(jg)[0], Cc),
                               atol=1e-4, rtol=1e-3)
    assert flushes < 3 * 2 * 4 * Rr * Ss // 2, flushes


def test_b_prime_walk_one_cell_flushes_once():
    """A ray that never leaves its cell flushes each real slot once per walk
    and side; in the bottom-right corner cell the three slots past the
    border never flush."""
    rng = np.random.default_rng(22)
    h, w, Cc, Ss = 10, 12, 16, 64
    feat = rng.normal(0, 1, (V, h, w, Cc)).astype(np.float32)
    inner = np.full((V, 1, Ss, 2), -0.2, np.float32) + rng.uniform(0, 1e-3, (V, 1, Ss, 2))
    corner = np.full((V, 1, Ss, 2), 1.0, np.float32)
    gcot = rng.normal(0, 1, (1, Ss, 2)).astype(np.float32)
    for grids, per_side in ((inner, 4), (corner, 1)):
        got, flushes = b_prime_walks(feat, grids.astype(np.float32), gcot, 2, 64)
        assert flushes == 3 * 2 * per_side
        t = torch.tensor(feat, requires_grad=True)
        tcp.cosine_prior_plain(t, torch.tensor(grids), None, 2).backward(torch.tensor(gcot))
        np.testing.assert_allclose(got, t.grad.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(t.grad.numpy()).max())
