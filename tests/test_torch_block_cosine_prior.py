"""Kernel D (block-union cosine prior) of the PyTorch port vs the JAX
package, on the CPU.

- The union helpers (`base_cells`, `block_union_cells`,
  `block_union_size_raw`, `bucket_ut`) give the JAX integers exactly, on
  coherent grids and on a ragged R with samples pushed onto the border.
- The plain Kernel D vs JAX `block_banded_cosine_scale` (Pallas, interpret
  mode): atol 1e-2 on int8 tables, the bound tests/test_pallas_block_banded.py
  sets for that kernel's bf16 stencil weights; atol 2e-5 on f32 tables (f32
  one-hot matmul vs direct f32 interpolation, summation order only).
- The plain Kernel D vs the port's plain Kernel B on the same int8 tables:
  atol 1e-5, the same taps and f32 weights reached by another route.
- On bf16 tables (configs/train.yaml's eval renders, which the JAX package
  sends through `block_banded_cosine_scale_trainable`, whose forward is
  `block_banded_cosine_scale`): the JAX kernel at atol 1e-2 (its bf16
  stencil), the port's plain Kernel B at atol 1e-5; the bf16 staging fits
  every bucket at S = 128 and the route (`takes_table`) follows the dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cosine_prior import _cosine_bwd, _edge_grids, _slot_footprint

from matchnerf_tpu.models.gmflow.gmflow import pair_index_lists
from matchnerf_tpu.ops import pallas_block_banded as jbb
from matchnerf_tpu_torch.ops import block_cosine_prior as kd
from matchnerf_tpu_torch.ops import cosine_prior as kb
from matchnerf_tpu_torch.ops.grid_sample import bilinear_taps
from torch_threads import one_torch_thread  # noqa: F401

V = 3


def _coherent_grids(rng, R, S, spread=0.6):
    """Monotone straight segments per ray (epipolar-like) [V,R,S,2]; rays of
    one 8-ray block start close together, as adjacent pixels do."""
    starts = rng.uniform(-1.1, 0.3, (V, (R + 7) // 8, 1, 2)) \
        + rng.normal(0, 0.01, (V, (R + 7) // 8, 8, 2))
    starts = starts.reshape(V, -1, 2)[:, :R]
    ends = starts + rng.uniform(0.05, spread, (V, R, 2))
    t = np.linspace(0, 1, S)[None, None, :, None]
    return (starts[:, :, None, :] * (1 - t) + ends[:, :, None, :] * t).astype(np.float32)


def _border_grids(rng, R, S):
    """Ragged R with the first samples of every ray pushed past the border."""
    g = _coherent_grids(rng, R, S)
    g[:, :, :3] = np.clip(g[:, :, :3] * 3.0, -1.0, 1.0)
    g[:, -1, -2:] = 1.0                               # the (H-1, W-1) corner
    return g


def _int8_table(rng, H, W, C):
    feat = rng.normal(0, 1, (V, H, W, 2 * C)).astype(np.float32)
    scale = np.maximum(np.abs(feat).max(axis=(1, 2)), 1e-12) / 127.0     # [V,Cc]
    q = np.clip(np.round(feat / scale[:, None, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _pad_np(grids):
    pad = (-grids.shape[1]) % 8
    return np.concatenate([grids, np.repeat(grids[:, -1:], pad, axis=1)], axis=1)


def _ut(grids, H, W):
    return kd.bucket_ut(kd.block_union_size_raw(torch.tensor(_pad_np(grids)), H, W))


@pytest.mark.parametrize("case", ["coherent", "ragged_border"])
def test_union_helpers_match_jax(case):
    rng = np.random.default_rng(10)
    H, W, R, S = (24, 32, 24, 32) if case == "coherent" else (16, 16, 11, 16)
    grids = _coherent_grids(rng, R, S) if case == "coherent" else _border_grids(rng, R, S)
    gp = _pad_np(grids)

    cells = kd.base_cells(torch.tensor(gp), H, W).reshape(-1, S)
    jcells = jbb._cells_weights4(jnp.asarray(gp), H, W)[0].reshape(-1, S)
    assert cells.dtype == torch.int32
    np.testing.assert_array_equal(cells.numpy(), np.asarray(jcells))

    n = kd.block_union_size_raw(torch.tensor(gp), H, W)
    assert n == int(jbb.block_union_size_raw(jnp.asarray(gp), H, W))
    ut = kd.bucket_ut(n)
    assert ut == jbb.bucket_ut(n) and ut is not None

    for cap in (ut, 64):                      # 64 truncates the wider unions
        got = kd.block_union_cells(cells, 8, cap, H, W)
        want = jbb.block_union_cells(jcells, 8, cap, H, W)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got >= 0).sum(-1).max()) == min(n, 64)


def test_bucket_ut_matches_jax():
    for n in (0, 1, 64, 65, 300, 512, 513, 4096):
        assert kd.bucket_ut(n) == jbb.bucket_ut(n)
    assert kd.UT_BUCKETS == jbb.UT_BUCKETS


@pytest.mark.parametrize("case", ["coherent", "ragged_border"])
def test_plain_kernel_d_int8_matches_jax_and_kernel_b(case):
    rng = np.random.default_rng(11)
    H, W, C, R, S, G = (24, 32, 16, 24, 32, 4) if case == "coherent" \
        else (16, 16, 8, 11, 16, 2)
    q, scale = _int8_table(rng, H, W, C)
    grids = _coherent_grids(rng, R, S) if case == "coherent" else _border_grids(rng, R, S)
    ut = _ut(grids, H, W)
    ref = jbb.block_banded_cosine_scale(
        jnp.asarray(q)[None], jnp.asarray(grids)[:, None], kt=S, ut=ut, n_groups=G,
        pairs=pair_index_lists(V), dequant_scales=jnp.asarray(scale)[None])
    got = kd.block_cosine_prior(torch.tensor(q), torch.tensor(grids),
                                torch.tensor(scale), G, ut)
    assert got.shape == (R, S, G) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0], atol=1e-2)
    plain_b = kb.cosine_prior_plain(torch.tensor(q), torch.tensor(grids),
                                    torch.tensor(scale), G)
    np.testing.assert_allclose(got.numpy(), plain_b.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["coherent", "ragged_border"])
def test_plain_kernel_d_bf16_matches_jax_and_kernel_b(case):
    rng = np.random.default_rng(14)
    H, W, C, R, S, G = (24, 32, 16, 24, 32, 4) if case == "coherent" \
        else (16, 16, 8, 11, 16, 2)
    feat = rng.normal(0, 1, (V, H, W, 2 * C)).astype(np.float32)
    grids = _coherent_grids(rng, R, S) if case == "coherent" else _border_grids(rng, R, S)
    ut = _ut(grids, H, W)
    tb = torch.tensor(feat).to(torch.bfloat16)
    ref = jbb.block_banded_cosine_scale(
        jnp.asarray(feat).astype(jnp.bfloat16)[None], jnp.asarray(grids)[:, None], kt=S,
        ut=ut, n_groups=G, pairs=pair_index_lists(V))
    got = kd.block_cosine_prior(tb, torch.tensor(grids), None, G, ut)
    assert got.shape == (R, S, G) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0], atol=1e-2)
    plain_b = kb.cosine_prior_plain(tb, torch.tensor(grids), None, G)
    np.testing.assert_allclose(got.numpy(), plain_b.numpy(), atol=1e-5, rtol=0)


def test_block_route_by_table_dtype():
    """Kernel D takes int8 and bf16 tables at every bucket at S = 128 (bf16
    stages 128 channels a pass up to ut 320, 64 above), f32 tables where
    D' fits (`takes_f32`); otherwise, and with scales on a float table,
    Kernel B."""
    t = {dt: torch.zeros(3, 4, 4, 8, dtype=dt)
         for dt in (torch.int8, torch.bfloat16, torch.float32)}
    for ut in kd.UT_BUCKETS:
        for G in (2, 8):
            assert kd.takes_table(t[torch.int8], torch.ones(3, 8), ut, 128, G)
            assert kd.takes_table(t[torch.bfloat16], None, ut, 128, G)
            assert kd.takes_table(t[torch.float32], None, ut, 128, G) == kd.takes_f32(ut, 128, G)
            assert not kd.takes_table(t[torch.bfloat16], torch.ones(3, 8), ut, 128, G)
    assert kd.channels_per_pass(320, 128, 8, False, itemsize=2) == 128
    assert kd.channels_per_pass(384, 128, 8, False, itemsize=2) == 64
    assert not kd.takes_bf16(512, 512, 2)


def _largest_rows(fits, W):
    """The most table rows of width W that `fits(h * W)` accepts."""
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid * W) else (lo, mid - 1)
    return lo


@pytest.mark.parametrize("S", [128, 256])
def test_block_route_table_size(S):
    """The kernel's union build holds two bitmaps of the table's h*w cells
    in shared memory (of one view at a time in the pair layout), so
    `takes_table` sends a table too large for them to Kernel B (B'): True
    at the largest h (W = 1024) that fits, False one row past it, for every
    table type. The DTU eval tables are far inside."""
    W = 1024
    for G in (2, 8):
        for ut in kd.UT_BUCKETS:
            for dt, fits in ((torch.int8, lambda hw: kd.takes_bf16(ut, S, G, hw)),
                             (torch.bfloat16, lambda hw: kd.takes_bf16(ut, S, G, hw)),
                             (torch.float32, lambda hw: kd.takes_f32(ut, S, G, hw))):
                scales = torch.ones(3, 256) if dt == torch.int8 else None
                if not fits(0):
                    assert not kd.takes_table(torch.empty(3, 64, 80, 256, dtype=dt,
                                                          device="meta"), scales, ut, S, G)
                    continue
                h = _largest_rows(fits, W)
                tables = [torch.empty(3, n, W, 256, dtype=dt, device="meta")
                          for n in (h, h + 1)]
                assert kd.takes_table(tables[0], scales, ut, S, G), (dt, ut, G)
                assert not kd.takes_table(tables[1], scales, ut, S, G), (dt, ut, G)
                itemsize = 4 if dt == torch.float32 else 2
                cp, pair, _ = kd.plan(ut, S, G, False, itemsize)
                assert kd.fwd_smem(ut, S, cp, itemsize, (h + 1) * W, 3, pair) > kd.MAX_SMEM
                for hw in ((64, 80), (128, 160)):
                    assert kd.takes_table(torch.empty(3, *hw, 256, dtype=dt, device="meta"),
                                          scales, ut, S, G)
    hmax = _largest_rows(lambda hw: kd.takes_bf16(512, S, 8, hw), W)
    # the layout that holds every view built the V = 3 unions at once:
    # 235k cells at S = 128 and 169k at S = 256; one view at a time
    assert (hmax * W) // 1000 == {128: 773, 256: 642}[S]


def _earlier_int8_smem(ut, S, G):
    """Shared memory of Kernel D's int8 form before the union moved into the
    kernel: int8 rows [2][ut+1][128], taps and fractions [3][8S] 8 B each,
    the unions [3][ut] int32 and an [8S][G] f32 accumulator; it raised where
    this passed the block's limit."""
    a16 = lambda n: -(-n // 16) * 16
    return a16(a16(2 * (ut + 1) * 128) + 3 * 8 * S * 16 + 3 * ut * 4) + 8 * S * G * 4


def test_int8_block_route_against_earlier_kernel():
    """int8 tables took Kernel D at every bucket (raising where its int8
    staging passed the block's shared memory); now they take it where the
    bf16 staging fits in either layout. Every configuration has G = 2 and 8
    (base.yaml `cos_n_group`), where the route is unchanged wherever the
    earlier kernel launched; at G = 1 four (S, ut) go to Kernel B (five
    before the pair layout took S = 256, ut 256)."""
    scales = torch.ones(3, 256)
    lost, gained = set(), set()
    for S in (128, 256):
        table = torch.empty(3, 128, 160, 256, dtype=torch.int8, device="meta")
        for G in (1, 2, 4, 8, 16):
            for ut in kd.UT_BUCKETS:
                earlier = _earlier_int8_smem(ut, S, G) <= kd.MAX_SMEM
                now = kd.takes_table(table, scales, ut, S, G)
                if earlier and not now:
                    lost.add((S, G, ut))
                if now and not earlier:
                    gained.add((S, G, ut))
    assert lost == {(128, 1, 384), (128, 1, 512), (256, 1, 320), (256, 1, 384)}
    assert all(G in (2, 4, 8, 16) for _, G, _ in gained) and (256, 8, 512) in gained
    assert (256, 2, 512) in gained


def test_plain_kernel_d_f32_matches_jax():
    rng = np.random.default_rng(12)
    H, W, C, R, S, G = 24, 32, 16, 16, 32, 4
    table = rng.normal(0, 1, (V, H, W, 2 * C)).astype(np.float32)
    grids = _coherent_grids(rng, R, S)
    ut = _ut(grids, H, W)
    ref = jbb.block_banded_cosine_scale(
        jnp.asarray(table)[None], jnp.asarray(grids)[:, None], kt=S, ut=ut,
        n_groups=G, pairs=pair_index_lists(V))
    got = kd.block_cosine_prior(torch.tensor(table), torch.tensor(grids), None, G, ut)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[0], atol=2e-5, rtol=1e-5)


def test_plain_kernel_d_overflowed_union_drops_taps():
    """A bucket smaller than the union leaves taps out of it: they add 0, so
    the result stays finite but moves. The renderer never lets this happen:
    pose_prep sends an overflowing scale to Kernel B."""
    rng = np.random.default_rng(13)
    H, W, C, R, S, G = 24, 32, 8, 8, 32, 2
    q, scale = _int8_table(rng, H, W, C)
    grids = _coherent_grids(rng, R, S, spread=1.2)
    assert kd.block_union_size_raw(torch.tensor(grids), H, W) > 64
    args = (torch.tensor(q), torch.tensor(grids), torch.tensor(scale), G)
    small = kd.block_cosine_prior(*args, 64)
    full = kd.block_cosine_prior(*args, _ut(grids, H, W))
    assert bool(torch.isfinite(small).all())
    assert float((small - full).abs().max()) > 1e-3


def _popc(words):
    return np.array([bin(int(w)).count("1") for w in words], np.int64)


def kernel_union(cells, ut, H, W):
    """numpy emulation of csrc/block_cosine_prior.cu's union build for one
    8-ray block: cells [V, L] base cells per view -> (unions [V, ut] -1
    padded, row(v, cell) -> the union row of a tap, ut when it is missing).
    One bitmap word array for the V views (the pair layout calls it once
    per view, V = 1); an exclusive scan of the words'
    popcounts ranks each set bit (prefix minus the view's first prefix plus
    the popcount below it); the first ut set bits, ascending, are the capped
    cells; those dilated by {c, c+1, c+W, c+W+1} below H*W fill a fresh
    bitmap, and its first ut set bits are the union."""
    nw = (H * W + 31) // 32
    V = len(cells)

    def bitmap(per_view):
        words = np.zeros(V * nw, np.uint32)
        for v, cs in enumerate(per_view):
            cs = np.asarray(cs, np.int64)
            np.bitwise_or.at(words, v * nw + (cs >> 5), np.left_shift(
                np.uint32(1), (cs & 31).astype(np.uint32)))
        return words, np.concatenate([[0], np.cumsum(_popc(words))[:-1]])

    def take_first(words, pre):
        out = []
        for v in range(V):
            cells_v = [32 * (i - v * nw) + b for i in range(v * nw, (v + 1) * nw)
                       for b in range(32) if (int(words[i]) >> b) & 1]
            ranks = [pre[(32 * v * nw + c) // 32] - pre[v * nw]
                     + int(_popc([int(words[v * nw + c // 32]) & ((1 << (c % 32)) - 1)])[0])
                     for c in cells_v]
            assert ranks == list(range(len(cells_v)))            # the scan ranks them
            out.append(cells_v[:ut])
        return out

    first = take_first(*bitmap(cells))
    dil = [[d for c in cs for d in (c, c + 1, c + W, c + W + 1) if d < H * W] for cs in first]
    words, pre = bitmap(dil)
    union = take_first(words, pre)

    def row(v, cell):
        i = v * nw + cell // 32
        if not (int(words[i]) >> (cell % 32)) & 1:
            return ut
        rank = pre[i] - pre[v * nw] + int(_popc([int(words[i]) & ((1 << (cell % 32)) - 1)])[0])
        return rank if rank < ut else ut

    unions = np.full((V, ut), -1, np.int64)
    for v, u in enumerate(union):
        unions[v, :len(u)] = u
    return unions, row


@pytest.mark.parametrize("case,cap", [("coherent", None), ("coherent", 32),
                                      ("ragged_border", None), ("wide", 96)])
def test_kernel_union_build_matches_sorts(case, cap):
    """The kernel's bitmap union equals `block_union_cells` (torch sorts)
    and the JAX `block_union_cells` block by block, at the pose's bucket
    and at a cap below the true union (the first ut cells kept at both
    steps); each tap's union row equals `union_positions`', missing taps
    (only past the cap) pointing at the zero row ut."""
    rng = np.random.default_rng(15)
    H, W, R, S = (16, 16, 11, 16) if case == "ragged_border" else (24, 32, 24, 32)
    if case == "coherent":
        grids = _coherent_grids(rng, R, S)
    elif case == "wide":
        grids = _coherent_grids(rng, R, S, spread=1.2)
    else:
        grids = _border_grids(rng, R, S)
    gp = _pad_np(grids)
    n = kd.block_union_size_raw(torch.tensor(gp), H, W)
    ut = cap or kd.bucket_ut(n)
    assert (n > ut) == (cap is not None), (n, ut)
    cells = kd.base_cells(torch.tensor(gp), H, W)                   # [V, Rp, S]
    NB = gp.shape[1] // 8
    torch_u = kd.block_union_cells(cells.reshape(V * gp.shape[1], S), 8, ut, H, W)
    jax_u = np.asarray(jbb.block_union_cells(jnp.asarray(cells.numpy().reshape(-1, S)), 8,
                                             ut, H, W))
    (y0, x0, y1, x1), _ = bilinear_taps(torch.tensor(gp), H, W)
    for blk in range(NB):
        blk_cells = cells[:, blk * 8:(blk + 1) * 8].reshape(V, -1).numpy()
        unions, row = kernel_union(blk_cells, ut, H, W)
        for v in range(V):
            want = np.full(ut, -1)
            tu = torch_u[v * NB + blk].numpy()
            want[:len(tu)] = tu
            np.testing.assert_array_equal(unions[v], want)
            np.testing.assert_array_equal(jax_u[v * NB + blk][:ut], want[:jax_u.shape[1]])
            taps = torch.stack([(yy * W + xx)[v, blk * 8:(blk + 1) * 8].reshape(-1)
                                for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))], 1)
            pos, found = kd.union_positions(torch.tensor(want)[None].int(),
                                            taps.reshape(1, -1), H * W)
            want_rows = torch.where(found, pos, ut)[0].numpy()
            np.testing.assert_array_equal(
                [row(v, int(c)) for c in taps.reshape(-1)], want_rows)


INT_MAX = 2 ** 31 - 1


def find_row(u, ut, key):
    """find_row of csrc/block_cosine_prior.cu: the lower bound of key in the
    ascending union u[0..ut) (INT_MAX padded), or ut where key is missing."""
    lo, hi = 0, ut
    while lo < hi:
        mid = (lo + hi) >> 1
        if u[mid] < key:
            lo = mid + 1
        else:
            hi = mid
    return lo if lo < ut and u[lo] == key else ut


def row_and_next(u, ut, c, right):
    """row_and_next of csrc/block_cosine_prior.cu: the rows of cell c and,
    where `right`, of c + 1 (else ut), the second the row after c's where
    the union holds c + 1 there, else searched."""
    r0 = find_row(u, ut, c)
    if not right:
        return r0, ut
    return r0, r0 + 1 if r0 + 1 < ut and u[r0 + 1] == c + 1 else find_row(u, ut, c + 1)


@pytest.mark.parametrize("case,cap", [("coherent", None), ("coherent", 32),
                                      ("ragged_border", None), ("wide", 96)])
def test_pair_layout_rows_match_the_bitmap_ranks(case, cap):
    """The pair layout builds each view's union on its own (the bitmap build
    of one view) and finds a sample's union rows by binary search in it
    (`find_row`, `row_and_next`: one search for (y, x0) and the next row
    for (y, x0 + 1) where the union holds it there): the same unions as the
    build of every view at once, and for every tap of the forward ((y0,
    x0), (y0, x1), (y1, x0), (y1, x1), the far ones clamped to the table)
    and every parity slot of the backward the row the bitmap rank gives,
    the zero row ut where a cell is missing or ranks past ut (at a cap
    below the union too)."""
    rng = np.random.default_rng(16)
    H, W, R, S = (16, 16, 11, 16) if case == "ragged_border" else (24, 32, 24, 32)
    grids = (_coherent_grids(rng, R, S, spread=1.2) if case == "wide"
             else _coherent_grids(rng, R, S) if case == "coherent" else _border_grids(rng, R, S))
    gp = _pad_np(grids)
    n = kd.block_union_size_raw(torch.tensor(gp), H, W)
    ut = cap or kd.bucket_ut(n)
    assert (n > ut) == (cap is not None), (n, ut)
    cells = kd.base_cells(torch.tensor(gp), H, W)                   # [V, Rp, S]
    (y0, x0, y1, x1), _ = bilinear_taps(torch.tensor(gp), H, W)
    missing = 0
    for blk in range(gp.shape[1] // 8):
        blk_cells = cells[:, blk * 8:(blk + 1) * 8].reshape(V, -1).numpy()
        unions, row = kernel_union(blk_cells, ut, H, W)
        for v in range(V):
            one, _ = kernel_union(blk_cells[v:v + 1], ut, H, W)
            np.testing.assert_array_equal(one[0], unions[v])
            u = np.where(unions[v] < 0, INT_MAX, unions[v])
            sl = (v, slice(blk * 8, (blk + 1) * 8))
            yy0, xx0, yy1, xx1 = (t[sl].reshape(-1).numpy() for t in (y0, x0, y1, x1))
            for a, b, c, d in zip(yy0, xx0, yy1, xx1):
                for cell in (a * W + b, a * W + d, c * W + b, c * W + d):
                    assert find_row(u, ut, cell) == row(v, int(cell))
                    missing += find_row(u, ut, cell) == ut
                # the kernels' two searches a sample: rows (y, x0) and (y, x0 + 1)
                for y in (a, a + 1):
                    if y >= H:
                        continue
                    r0, r1 = row_and_next(u, ut, y * W + b, b + 1 < W)
                    assert r0 == row(v, int(y * W + b))
                    assert r1 == (row(v, int(y * W + b + 1)) if b + 1 < W else ut)
                for sl_ in range(4):
                    ys = a + ((sl_ >> 1) ^ (a & 1))
                    xs = b + ((sl_ & 1) ^ (b & 1))
                    want = row(v, int(ys * W + xs)) if ys < H and xs < W else ut
                    got = find_row(u, ut, ys * W + xs) if ys < H and xs < W else ut
                    assert got == want
    assert (missing > 0) == (cap is not None), missing


def pair_slot_searches(n_views):
    """The pair layout's taps slots over the pairs of csrc/views.cuh
    (`held` in the kernels): per pair (i, j) the views searched before its
    first pass, i into slot 0 where slot 0 held another view, j into slot
    1 -> [((i, j), searched)]."""
    held, out = -1, []
    for i, j in pair_index_lists(n_views):
        out.append(((i, j), ([i] if i != held else []) + [j]))
        held = i
    return out


@pytest.mark.parametrize("n_views", [2, 3, 8, 10, 16])
def test_pair_layout_keeps_the_first_view(n_views):
    """The pairs run by first view, so slot 0 keeps view i for its
    V - 1 - i partners: the pair layout searches P + V - 1 views' taps in
    all (P for slot 1, one per first view for slot 0), where the layout
    that holds every view finds V views' once, and every pair's slots hold
    its own two views."""
    P = n_views * (n_views - 1) // 2
    walk = pair_slot_searches(n_views)
    assert sum(len(searched) for _, searched in walk) == P + n_views - 1
    slots = [None, None]
    for (i, j), searched in walk:
        if i in searched[:-1]:
            slots[0] = i
        slots[1] = searched[-1]
        assert slots == [i, j], (i, j, slots)


# the route before the pair layout, frozen (its arithmetic as it was): every
# view's taps and fractions, 16 B a (view, sample), and every view's
# bitmaps at once in the union build
def _fwd_smem_views(ut, S, cp, itemsize, hw, n_views):
    staged = 2 * (ut + 1) * cp * itemsize
    scratch = (2 * n_views * ((hw + 31) // 32) + 32) * 4
    return -(-max(staged, scratch) // 16) * 16 + n_views * (8 * S * 16 + ut * 4)


def _bwd_smem_views(ut, S, cp, n_views):
    return 4 * (ut + 1) * cp * 4 + n_views * (8 * S * 16 + ut * 4)


# the pair layout as the header reckons it: the taps and fractions of two
# views, one view's bitmaps, every view's union; the backward's rows in
# `bufs` buffers
def _fwd_smem_pair(ut, S, cp, itemsize, hw, n_views):
    staged = 2 * (ut + 1) * cp * itemsize
    scratch = (2 * ((hw + 31) // 32) + 32) * 4
    return -(-max(staged, scratch) // 16) * 16 + 2 * 8 * S * 16 + n_views * ut * 4


def _bwd_smem_pair(ut, S, cp, n_views, bufs):
    return 2 * bufs * (ut + 1) * cp * 4 + 2 * 8 * S * 16 + n_views * ut * 4


def _widths(G):
    return [cp for cp in (128, 64, 32) if 128 <= G * cp <= 2048]


def _earlier_takes(dt, ut, S, G, hw, n_views):
    """The route before the pair layout (frozen)."""
    itemsize = 4 if dt == torch.float32 else 2
    fwd = any(_fwd_smem_views(ut, S, cp, itemsize, hw, n_views) <= kd.MAX_SMEM
              for cp in _widths(G))
    if dt != torch.float32:
        return fwd
    return fwd and any(_bwd_smem_views(ut, S, cp, n_views) <= kd.MAX_SMEM for cp in _widths(G))


def _pair_takes(dt, ut, S, G, hw, n_views):
    """Whether the pair layout alone takes the bucket."""
    itemsize = 4 if dt == torch.float32 else 2
    fwd = any(_fwd_smem_pair(ut, S, cp, itemsize, hw, n_views) <= kd.MAX_SMEM
              for cp in _widths(G))
    if dt != torch.float32:
        return fwd
    return fwd and any(_bwd_smem_pair(ut, S, cp, n_views, bufs) <= kd.MAX_SMEM
                       for cp in _widths(G) for bufs in (2, 1))


# (scale 0, scale 1) tables: DTU 640x512, LLFF 960x640, Blender 800x800
ROUTE_TABLES = {"dtu": ((64, 80), (128, 160)), "llff": ((80, 120), (160, 240)),
                "blender": ((100, 100), (200, 200))}


@pytest.mark.parametrize("S", [64, 128, 256])
def test_route_takes_the_pair_layouts_domain(S):
    """For V = 2 to 16, every bucket, G = 1, 2 and 8 and the DTU, LLFF and
    Blender tables of both scales: `takes_table` takes exactly what the
    layout that holds every view took (its arithmetic frozen) or the
    pair layout takes, so it loses nothing, and `plan` keeps the earlier
    layout wherever it fits. On the DTU tables at G = 2 and 8 int8 and bf16
    tables take Kernel D at every bucket, and f32 tables take D' at least
    wherever three views took it (S = 128: ut <= 160 at G = 2, <= 320 at
    G = 8; S = 64: <= 192, <= 384)."""
    least = {(128, 2): 160, (128, 8): 320, (64, 2): 192, (64, 8): 384}
    gained = 0
    for name, hws in ROUTE_TABLES.items():
        for h, w in hws:
            for V in range(2, 17):
                scales = torch.ones(V, (V - 1) * 128)
                for G in (1, 2, 8):
                    for ut in kd.UT_BUCKETS:
                        for dt in (torch.int8, torch.bfloat16, torch.float32):
                            table = torch.empty(V, h, w, (V - 1) * 128, dtype=dt, device="meta")
                            now = kd.takes_table(table, scales if dt == torch.int8 else None,
                                                 ut, S, G)
                            before = _earlier_takes(dt, ut, S, G, h * w, V)
                            assert now == (before or _pair_takes(dt, ut, S, G, h * w, V)), \
                                (name, h, w, V, G, ut, dt)
                            gained += now and not before
                            itemsize = 4 if dt == torch.float32 else 2
                            how = kd.plan(ut, S, G, False, itemsize, h * w, V)
                            fwd_before = any(_fwd_smem_views(ut, S, cp, itemsize, h * w, V)
                                             <= kd.MAX_SMEM for cp in _widths(G))
                            assert (how is not None and not how.pair) == fwd_before
                            if name != "dtu" or G == 1:
                                continue
                            if dt != torch.float32:
                                assert now, (h, w, V, G, ut)
                            elif ut <= least.get((S, G), 0):
                                assert now, (h, w, V, G, ut)
    assert gained > 0


def test_pair_layout_bytes_mirror_the_header():
    """`fwd_smem` / `bwd_smem` with pair=True are csrc LayoutFwd /
    LayoutPass of the pair layout region by region (`pass_buffers` picks
    the backward's row buffers as csrc pass_buffers does), and the byte
    counts block_cosine_prior.cu's header gives for it are theirs."""
    for S in (64, 128, 256):
        for ut in kd.UT_BUCKETS:
            for cp in (32, 64, 128):
                for V in (2, 3, 9, 16):
                    for hw in (0, 64 * 80, 160 * 240, 240 * 1024):
                        for itemsize in (2, 4):
                            assert kd.fwd_smem(ut, S, cp, itemsize, hw, V, True) == \
                                _fwd_smem_pair(ut, S, cp, itemsize, hw, V)
                            assert kd.fwd_smem(ut, S, cp, itemsize, hw, V) == \
                                _fwd_smem_views(ut, S, cp, itemsize, hw, V)
                    for bufs in (1, 2):
                        assert kd.bwd_smem(ut, S, cp, V, True, bufs) == \
                            _bwd_smem_pair(ut, S, cp, V, bufs)
                    assert kd.pass_buffers(ut, S, cp, V) == (
                        2 if _bwd_smem_pair(ut, S, cp, V, 2) <= kd.MAX_SMEM else 1)
    with open(kd.kernels.CSRC_DIR / "block_cosine_prior.cu") as f:
        header = " ".join(line.lstrip("/ ").rstrip() for line in f)
    dtu = 128 * 160
    stated = {229632: kd.fwd_smem(512, 256, 64, 2, dtu, 16, True),
              196864: kd.fwd_smem(512, 128, 64, 2, dtu, 16, True),
              207872: kd.bwd_smem(160, 128, 64, 16, True, 2),
              217600: kd.bwd_smem(320, 128, 32, 16, True, 2),
              5248: (2 * ((dtu + 31) // 32) + 32) * 4,
              262656: 2 * 513 * 128 * 2}
    for value, reckoned in stated.items():
        assert value == reckoned and f"{value:,}" in header, value
    assert kd.bwd_smem(512, 128, 32, 16, True, 1) == 196864
    assert (kd.pass_buffers(160, 128, 64, 16), kd.pass_buffers(512, 128, 32, 16)) == (2, 1)
    assert kd.plan(512, 256, 2, False, 2, dtu, 16) == kd.Plan(64, True)
    assert kd.plan(512, 128, 8, True, n_views=16) == kd.Plan(32, True, 1)


def pair_cosine8(a, b, c0, SW, G):
    """pair_cosine8 of csrc/block_cosine_prior.cu in numpy: a, b [n, CP] the CP channels from c0
    in hand; lane l (of 8) slot k holds channels k*8*SW + l*SW .. +SW-1.
    Slots of one group sum by an xor butterfly, lanes of one group by xor
    shuffles -> {group: cosine [n]} from the lanes and slots that emit."""
    n, CP = a.shape
    NS = CP // (8 * SW)
    idx = np.array([[k * 8 * SW + l * SW + np.arange(SW) for k in range(NS)]
                    for l in range(8)])                               # [8, NS, SW]
    d, p, q = ((x[:, idx] * y[:, idx]).sum(-1) for x, y in ((a, b), (a, a), (b, b)))
    gsize, span = 128 // G, 8 * SW
    spg = gsize // span if gsize > span else 1
    lpg = 8 if gsize > span else gsize // SW
    s_ = 1
    while s_ < NS:
        if s_ < spg:
            swap = np.arange(NS) ^ s_
            d, p, q = d + d[:, :, swap], p + p[:, :, swap], q + q[:, :, swap]
        s_ *= 2
    off = lpg // 2
    while off:
        lanes = np.arange(8) ^ off
        d, p, q = d + d[:, lanes], p + p[:, lanes], q + q[:, lanes]
        off //= 2
    out = {}
    for lane in range(0, 8, lpg):
        for k in range(0, NS, spg):
            g = (c0 + k * span + lane * SW) // gsize
            assert g not in out                     # each group emitted once
            out[g] = d[:, lane, k] / (np.maximum(np.sqrt(p[:, lane, k]), 1e-8)
                                      * np.maximum(np.sqrt(q[:, lane, k]), 1e-8))
    return out


@pytest.mark.parametrize("n_groups,SW,CP", [
    (g, sw, cp) for g in (1, 2, 4, 8, 16)
    for sw, cp in ((8, 128), (8, 64), (4, 128), (4, 64), (4, 32))
    if g * cp >= 128])              # a cosine group lies inside one pass
def test_pair_cosine_slot_layout(n_groups, SW, CP):
    """Kernel D's eight-lane slot layout (staged bf16 rows: slots of 8
    channels, of 4 in 32-channel passes; f32 rows: 4; passes of 128, 64 or
    32 channels), emulated in numpy: every group of every pass is emitted
    once and equals the grouped cosine."""
    rng = np.random.default_rng(4)
    a = rng.normal(0, 1, (5, 128)).astype(np.float32)
    b = rng.normal(0, 1, (5, 128)).astype(np.float32)
    ref = kb.grouped_cosine(torch.tensor(a), torch.tensor(b), n_groups).numpy()
    gsize = 128 // n_groups
    for c0 in range(0, 128, CP):
        got = pair_cosine8(a[:, c0:c0 + CP], b[:, c0:c0 + CP], c0, SW, n_groups)
        assert sorted(got) == list(range(c0 // gsize, (c0 + CP) // gsize))
        for g, cos in got.items():
            np.testing.assert_allclose(cos, ref[:, g], atol=1e-6, rtol=1e-5)


# --------------------------------------------------------- D''s backward walks
PAIRS = pair_index_lists(V)


def d_prime_walks(table, grids, g, n_groups, ut, walks):
    """csrc/block_cosine_prior.cu's D' backward in numpy, per 8-ray block:
    each sample's four taps in parity slots as rows of the block's union
    (the zero row ut past the border or missing from an overflowed union);
    `walks` walks (32, or 64 at 32 channels a pass), walk k on depths
    k * ceil(S / walks) onwards, each depth across the block's rays,
    serpentine (even depths rays 0..7, odd ones back), padded rays skipped;
    per pair each
    side's slots sum their row's gradient while the row stays and add it to
    the block's d_acc when it changes and at the walk's end (never the zero
    row); then each union row of d_acc goes to d_table once. -> (d_table,
    the number of slot adds into d_acc)."""
    Vv, h, w, Cc = table.shape
    C = Cc // 2
    R, S = grids.shape[1:3]
    gp = _pad_np(grids)
    NB = gp.shape[1] // 8
    unions = kd.block_unions(torch.tensor(gp), h, w, ut).numpy().reshape(Vv, NB, ut)
    rows = table.reshape(Vv, h * w, Cc).astype(np.float64)
    d = np.zeros_like(rows)
    seg = -(-S // walks)
    adds = 0
    for b in range(NB):
        slots = []
        for v in range(Vv):
            cells, keys, wts = _slot_footprint(gp[v, 8 * b:8 * b + 8].reshape(-1, 2), h, w)
            u = np.where(unions[v, b] < 0, h * w, unions[v, b])
            pos = np.minimum(np.searchsorted(u, cells), ut - 1)
            slots.append((np.where((keys >= 0) & (u[pos] == cells), pos, ut), wts))
        for (i, j) in PAIRS:
            sides = ((i, (j - 1) * C), (j, i * C))
            staged = [np.concatenate([np.where(unions[v, b, :, None] >= 0,
                                               rows[v, np.maximum(unions[v, b], 0), c0:c0 + C],
                                               0.0), np.zeros((1, C))]) for v, c0 in sides]
            dacc = np.zeros((2, ut + 1, C))
            for k in range(walks):
                keys, acc = [[ut] * 4, [ut] * 4], np.zeros((2, 4, C))
                walk = [(ray if d % 2 == 0 else 7 - ray, pos)
                        for d, pos in enumerate(range(k * seg, min(S, (k + 1) * seg)))
                        for ray in range(8)]
                for ray, pos in walk:
                    if 8 * b + ray >= R:
                        continue
                    nl = ray * S + pos
                    f = [(slots[v][1][nl][:, None] * staged[side][slots[v][0][nl]]).sum(0)
                         for side, (v, _) in enumerate(sides)]
                    dfs = _cosine_bwd(f[0], f[1], g[8 * b + ray, pos].astype(np.float64) / 3.0,
                                      n_groups)
                    for side, (v, _) in enumerate(sides):
                        for s in range(4):
                            new, wt = slots[v][0][nl][s], slots[v][1][nl][s]
                            if new != keys[side][s]:
                                if keys[side][s] != ut:
                                    dacc[side, keys[side][s]] += acc[side, s]
                                    adds += 1
                                keys[side][s], acc[side, s] = new, wt * dfs[side]
                            else:
                                acc[side, s] += wt * dfs[side]
                for side in range(2):
                    for s in range(4):
                        if keys[side][s] != ut:
                            dacc[side, keys[side][s]] += acc[side, s]
                            adds += 1
            for side, (v, c0) in enumerate(sides):
                for r in np.nonzero(unions[v, b] >= 0)[0]:
                    d[v, unions[v, b, r], c0:c0 + C] += dacc[side, r]
    return d.reshape(table.shape), adds


@pytest.mark.parametrize("n_groups,R,S,overflow,walks", [
    (1, 16, 24, False, 32), (2, 13, 30, False, 32), (4, 16, 24, True, 64),
    (8, 11, 24, False, 64), (8, 11, 70, False, 64), (16, 16, 28, False, 32)])
def test_d_prime_walks_match_plain_jax_and_b_prime(n_groups, R, S, overflow, walks):
    """D''s walks give the plain twin's table gradient, on rays that stay in
    one cell, run along the borders and revisit a cell, a ragged R (padded
    rays walk nothing) and S not a multiple of the walks (short bands, and
    at S = 70 of 64 walks bands of 2 depths and walks with none); without
    overflow also the JAX custom VJP's and B''s plain gradient (the same
    function); with a bucket below the union, taps missing from it add
    nothing, as in the plain twin. Fewer adds into d_acc than one per
    (sample, side, tap), even on these unrelated rays."""
    rng = np.random.default_rng(23)
    h, w, Cc = 12, 14, 64                              # 2 channels a group at G = 16
    feat = rng.normal(0, 1, (V, h, w, Cc)).astype(np.float32)
    grids = _edge_grids(rng, R, S)
    gcot = rng.normal(0, 1, (R, S, n_groups)).astype(np.float32)
    raw = kd.block_union_size_raw(torch.tensor(_pad_np(grids)), h, w)
    ut = 64 if overflow else kd.bucket_ut(raw)
    assert (raw > ut) == overflow, (raw, ut)
    got, adds = d_prime_walks(feat, grids, gcot, n_groups, ut, walks)

    def plain_grad(fn):
        t = torch.tensor(feat, requires_grad=True)
        fn(t, torch.tensor(grids)).backward(torch.tensor(gcot))
        return t.grad.numpy()

    ref = plain_grad(lambda t, gr: kd.block_cosine_prior_plain(t, gr, None, n_groups, ut))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert adds < 3 * 2 * 4 * R * S, adds
    if overflow:
        return
    ref_b = plain_grad(lambda t, gr: kb.cosine_prior_plain(t, gr, None, n_groups))
    np.testing.assert_allclose(got, ref_b, rtol=0, atol=1e-5 * np.abs(ref_b).max())
    gp = _pad_np(grids)
    pad = gp.shape[1] - R
    _, vjp = jax.vjp(lambda vf: jbb.block_banded_cosine_scale_trainable(
        vf, jnp.asarray(gp)[:, None], 4 * S, ut, n_groups, PAIRS, 8), jnp.asarray(feat)[None])
    (jg,) = vjp(jnp.asarray(np.pad(gcot, ((0, pad), (0, 0), (0, 0))))[None])
    np.testing.assert_allclose(got, np.asarray(jg)[0], atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("walks", [32, 64])
def test_d_prime_walks_merge_a_strip(walks):
    """On 8-pixel strips (adjacent rays an eighth of a cell apart, one
    direction per strip, as configs/train_fast.yaml draws them) the
    serpentine walks add to d_acc at most once per 4 (sample, side, tap),
    and the table gradient is the plain twin's."""
    rng = np.random.default_rng(24)
    h, w, Cc, R, S = 12, 14, 64, 16, 64
    start = rng.uniform(-0.8, 0.0, (V, R // 8, 1, 1, 2))
    step = rng.uniform(-0.4, 0.4, (V, R // 8, 1, 1, 2))
    ray = np.arange(8)[None, None, :, None, None] * np.array([2.0 / (w - 1) / 8, 0.0])
    depth = np.linspace(0, 1, S)[None, None, None, :, None]
    grids = (start + ray + step * depth).reshape(V, R, S, 2).astype(np.float32)
    feat = rng.normal(0, 1, (V, h, w, Cc)).astype(np.float32)
    gcot = rng.normal(0, 1, (R, S, 2)).astype(np.float32)
    ut = kd.bucket_ut(kd.block_union_size_raw(torch.tensor(_pad_np(grids)), h, w))
    got, adds = d_prime_walks(feat, grids, gcot, 2, ut, walks)
    t = torch.tensor(feat, requires_grad=True)
    kd.block_cosine_prior_plain(t, torch.tensor(grids), None, 2, ut).backward(
        torch.tensor(gcot))
    ref = t.grad.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert adds <= 3 * 2 * 4 * R * S // 4, adds
