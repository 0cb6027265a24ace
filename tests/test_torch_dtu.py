"""The port's DTU data path against the JAX package and the libraries it
replaces, on the CPU.

- `data/png.py`: greyscale, RGB and RGBA images written with each of the
  five row filters, with None / Up and all five mixed by row, and with the
  writer's adaptive choice (PIL's own choice of filters), decode bit-equal
  to PIL, so do PIL's own files; `read_pngs` (worker processes) on images
  of several shapes and kinds equals `read_png` on each; other kinds (16-bit, palette,
  interlaced) raise.
- `resize_nearest` equals `cv2.resize(..., INTER_NEAREST)`.
- `DTUDataset` on a synthetic DTU tree (`synth.write_dtu_tree`) against the
  JAX `DTUDataset`, item by item: train (the permuted sources from the same
  numpy generator), val and test; images, extrinsics, intrinsics,
  near_fars, view_ids and depth exact; with img_wh at the files' size (no
  PIL) and at half of it (PIL bilinear, CPU only).
- `DataLoader`'s batch order against the JAX loader's `_batch_indices`:
  shuffled per epoch from seed + epoch, `set_epoch`, the epoch advancing
  per pass, `drop_last`; its loading thread stops with the pass and hands
  errors to the consumer.
"""
import struct
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

from matchnerf_tpu.data.dtu import DTUDataset as JaxDTU
from matchnerf_tpu.data.loader import DataLoader as JaxLoader
from matchnerf_tpu_torch.data import png
from matchnerf_tpu_torch.data.common import resize_nearest
from matchnerf_tpu_torch.data.dtu import DTUDataset
from matchnerf_tpu_torch.data.loader import DataLoader
from matchnerf_tpu_torch.data.synth import write_dtu_tree

VIEW_IDS = [20, 21, 22, 23, 24, 25]


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_matches_pil(tmp_path, channels):
    rng = np.random.default_rng(channels)
    smooth = np.add.outer(np.arange(23), 3 * np.arange(37))[..., None] * np.arange(1, 5)
    img = ((smooth + rng.integers(0, 9, smooth.shape)) % 256).astype(np.uint8)
    img = img[..., 0] if channels == 1 else img[..., :channels]
    rows = np.arange(img.shape[0])
    for ftype in [0, 1, 2, 3, 4, rows % 2 * 2, rows % 5, "adaptive"]:
        path = str(tmp_path / "f.png")
        png.write_png(path, img, ftype)
        want = np.asarray(Image.open(path))
        got = png.read_png(path)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, img)
    adaptive = png._read_filtered(path)[1]
    path = str(tmp_path / "pil.png")
    Image.fromarray(img).save(path, optimize=True)         # PIL's adaptive filters
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(png._read_filtered(path)[1], adaptive)


def test_read_pngs_matches_read_png(tmp_path):
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in [(9, 14, 3), (9, 14, 3), (6, 5), (9, 14, 4), (9, 14, 3), (6, 5)]]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"{i}.png"))
        png.write_png(paths[-1], img, np.arange(img.shape[0]) % 5)
    got = png.read_pngs(paths)
    assert len(got) == len(imgs)
    for path, img, g in zip(paths, imgs, got):
        np.testing.assert_array_equal(g, img)
        np.testing.assert_array_equal(png.read_png(path), img)


def test_png_decoder_refuses_other_kinds(tmp_path):
    img = np.arange(12 * 9, dtype=np.uint8).reshape(12, 9)
    cases = {"palette": Image.fromarray(img).convert("P"),
             "grey16": Image.fromarray(img.astype(np.uint16) * 300),
             "grey_alpha": Image.fromarray(np.stack([img, img], -1), mode="LA")}
    for name, im in cases.items():
        path = str(tmp_path / f"{name}.png")
        im.save(path)
        with pytest.raises(ValueError):
            png.read_png(path)
    # the interlace byte of IHDR set (its CRC recomputed)
    path = str(tmp_path / "interlaced.png")
    png.write_png(path, np.stack([img] * 3, -1))
    data = bytearray(open(path, "rb").read())
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xffffffff)
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlace 1"):
        png.read_png(path)


@pytest.mark.parametrize("shape", [(1200, 1600), (37, 53)])
def test_resize_nearest_matches_cv2(shape):
    import cv2
    a = np.random.default_rng(0).random(shape).astype(np.float32)
    for f in (0.5, 0.25, 0.3):
        np.testing.assert_array_equal(
            resize_nearest(a, f), cv2.resize(a, None, fx=f, fy=f,
                                             interpolation=cv2.INTER_NEAREST))


@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    """Six posed 640x512 views (smooth images, noisy depth with holes) as
    scan1 of a DTU tree with its own meta dir; view 24 is the val and test
    target."""
    root = tmp_path_factory.mktemp("dtu")
    rng = np.random.default_rng(7)
    n = len(VIEW_IDS)
    yy, xx = np.mgrid[:512, :640]
    images = np.stack([np.stack([(xx + 40 * i) % 256, (yy + 7 * i) % 256,
                                 (xx + yy) // 5 % 256], -1) for i in range(n)]).astype(np.uint8)
    angles = np.deg2rad(np.linspace(-20, 20, n))
    w2cs, intrs = [], []
    for a in angles:
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        c2w[:3, 3] = [3.7 * np.sin(-a), -1.0 + 0.01 * a, -3.7 * np.cos(a)]
        w2cs.append(np.linalg.inv(c2w).astype(np.float32))
        intrs.append(np.array([[1152.0, 0, 320], [0, 1152.0, 256], [0, 0, 1]], np.float32))
    depths = rng.uniform(2.0, 4.0, (n, 512, 640)).astype(np.float32)
    depths[:, :50] = np.inf
    write_dtu_tree(str(root / "DTU"), str(root / "meta"), images, np.stack(w2cs),
                   np.stack(intrs), VIEW_IDS, val_view=24, depths=depths)
    return str(root / "DTU"), str(root / "meta")


def _assert_item_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in ("images", "extrinsics", "intrinsics", "near_fars", "view_ids", "img_wh",
              "depth"):
        if k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["scene"] == want["scene"]


@pytest.mark.parametrize("split,img_wh", [("train", (640, 512)), ("val", (640, 512)),
                                          ("test", (640, 512)), ("test", (320, 256))])
def test_dtu_matches_jax(dtu_tree, split, img_wh):
    root, meta = dtu_tree
    kw = dict(n_views=3, img_wh=img_wh, meta_dir=meta)
    ours = DTUDataset(root, split, rng=np.random.default_rng(3), **kw)
    ref = JaxDTU(root, split, rng=np.random.default_rng(3), **kw)
    assert len(ours) == len(ref) == {"train": 6 * 7, "val": 1, "test": 1}[split]
    assert ours.metas == ref.metas
    for i in ([5, 0, 17] if split == "train" else [0]):
        got, want = ours[i], ref[i]
        _assert_item_equal(got, want)
        assert got["images"].shape == (4, img_wh[1], img_wh[0], 3)
    if split != "train":
        assert got["depth"].shape == (512, 640) and (got["depth"] == 0).any()
        np.testing.assert_allclose(got["near_fars"][0], [2.125, 4.525], rtol=1e-6)


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i])}


@pytest.mark.parametrize("n,batch,drop_last", [(10, 1, False), (10, 3, False), (10, 3, True)])
def test_loader_order_matches_jax(n, batch, drop_last):
    ours = DataLoader(_Range(n), batch, shuffle=True, seed=5, drop_last=drop_last)
    ref = JaxLoader(_Range(n), batch_size=batch, shuffle=True, seed=5, drop_last=drop_last,
                    num_workers=1)
    assert len(ours) == len(ref)
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for _ in range(2):                     # each pass advances the epoch
            want = ref._batch_indices()
            assert [list(b) for b in ours.batch_indices()] == [list(b) for b in want]
            assert [list(b["i"][:, 0]) for b in ours] == [list(b) for b in want]
            ref._epoch += 1
    plain = DataLoader(_Range(n), batch)
    assert [list(b["i"][:, 0]) for b in plain] == [list(range(i, min(i + batch, n)))
                                                    for i in range(0, n, batch)]
    # leaving a pass early stops its loading thread; a loading error reaches
    # the consumer
    it = iter(plain)
    next(it)
    it.close()
    assert not any(t.name == "DataLoader" and t.is_alive() for t in threading.enumerate())

    class Broken(_Range):
        def __getitem__(self, i):
            if i == 2:
                raise KeyError("sample 2")
            return super().__getitem__(i)
    with pytest.raises(KeyError, match="sample 2"):
        list(DataLoader(Broken(n), 1))
