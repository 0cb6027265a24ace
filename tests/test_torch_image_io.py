"""Images without PIL: the port's JPEG decoder (`data/jpeg.py`), its resize
(`data/resample.py`) and the loaders on top of them, against PIL and the
JAX loaders, on the CPU. Every check is bit-equality (`np.array_equal`).

- `read_jpeg` / `decode_jpeg` against `np.asarray(Image.open(...))`: the
  three printer JPEGs of docs/demo_data (4:2:0 baseline at 504x378);
  PIL-written JPEGs of seeded images at 1x1, 17x13, 33x65 and 127x96, at
  subsampling 4:4:4, 4:2:2 and 4:2:0, quality 50, 95 and 100, with
  `optimize=True` (optimised Huffman tables), with restart markers
  (`restart_marker_blocks` / `restart_marker_rows`), with 0xFF fill bytes
  before the markers, and in greyscale;
  the port's own encoder (`synth.encode_jpeg`: 4:2:0 and greyscale) and,
  for the files PIL does not write, `_encode_variant` built from its
  pieces: 4:2:0, 4:2:2, 4:4:0 and 4:4:4, interleaved and not, with restart
  intervals, greyscale and Adobe RGB (transform 0). CMYK, 12-bit
  (baseline and progressive) and arithmetic-coded (sequential and
  progressive) files raise a ValueError naming the file and the marker;
  progressive files decode (tests/test_torch_image_io_progressive.py).
  `jpeg_size` and `common.image_size` against PIL's size.
- `resample.resize` against `Image.resize` for modes L, RGB and RGBA
  (through premultiplied RGBa), LANCZOS and BILINEAR, shrinking and
  enlarging, odd ratios and 1-pixel sides; the same size returns a copy.
- The port's T&T (JPEGs larger than img_wh), LLFF (JPEGs resized), DTU
  (another img_wh: BILINEAR) and COLMAP (the printer scene) loaders against
  the JAX loaders, every key of every sample.
- Coefficients far past a photo's, with 8- and 16-bit quantisation
  tables: the IDCT's 16-bit arithmetic as PIL's libjpeg-turbo has it.
  Damaged scans (cut, ending early, RSTn dropped, repeated or misnumbered,
  a flipped bit, junk bytes) decode as PIL decodes them; a DC table with a
  symbol above 15 raises.
- The sha256 constants that chip_smoke.py checks on the card: the printer
  images decoded and resized to configs/demo_own.yaml's 256x160, and
  decode(encode(seeded image)), each against PIL here.
- The port imports and loads the printer scene, a T&T tree and the
  printer scene re-saved progressive (chip_smoke's tree and fixture checks)
  with PIL blocked (`sys.modules["PIL"] = None`), in a subprocess; a host
  library that does not build raises.
"""
import hashlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import matchnerf_tpu.data as jdata
from matchnerf_tpu.data.llff import COLMAPDataset as JaxCOLMAP
from matchnerf_tpu_torch.data import DATASETS, common, jpeg, resample, synth
from matchnerf_tpu_torch.data.colmap import COLMAPDataset
from test_torch_datasets import _assert_loaders_equal, _assert_samples_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

PRINTER = os.path.join(REPO, "docs", "demo_data", "printer", "images")
SIZES = [(1, 1), (17, 13), (33, 65), (127, 96)]


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _assert_decodes_as_pil(data, tag):
    got, want = jpeg.decode_jpeg(data, tag), _pil(data)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, tag
    assert np.array_equal(got, want), (tag, int(np.abs(got.astype(int) - want).max()))


def _seeded(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _ceil(a, b):
    return -(-a // b)


def _variant_parts(img, quality, sampling=(2, 2), adobe_rgb=False):
    """What `_encode_variant` codes: the components ((h, v, table set)
    each), the two quantisation tables, each component's quantised blocks
    [by, bx, 64] (zig-zag) over whole MCUs, and the APPn segment (JFIF, or
    Adobe APP14 with transform 0 under `adobe_rgb`)."""
    H, W = img.shape[:2]
    x = img.astype(np.int64)
    if img.ndim == 2:
        planes, comps = [x], [(1, 1, 0)]
    elif adobe_rgb:
        planes, comps = [x[..., 0], x[..., 1], x[..., 2]], [(*sampling, 0), (1, 1, 0), (1, 1, 0)]
    else:
        planes, comps = synth._rgb_to_ycc(x), [(*sampling, 0), (1, 1, 1), (1, 1, 1)]
    hmax, vmax = comps[0][:2]
    grid = (_ceil(H, 8 * vmax) * 8 * vmax, _ceil(W, 8 * hmax) * 8 * hmax)
    qtabs = [synth.quality_table(synth._K1_LUMA, quality),
             synth.quality_table(synth._K2_CHROMA, quality)]
    blocks = [synth._blocks(p, grid, vmax // v, hmax // h, qtabs[t])
              for p, (h, v, t) in zip(planes, comps)]
    app = (synth._segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])) if adobe_rgb
           else synth.JFIF_APP0)
    return comps, qtabs, blocks, app


def _encode_variant(img, quality, sampling=(2, 2), restart_interval=0, interleaved=True,
                    adobe_rgb=False) -> bytes:
    """A baseline JPEG of a kind the decoder takes and PIL does not write,
    from the pieces of `synth.encode_jpeg`: luma at `sampling` = (h, v) per
    chroma sample ((1, 2) is 4:4:0); DRI and an RSTn marker every
    `restart_interval` MCUs (blocks, in a one-component scan); each
    component in a scan of its own unless `interleaved`; with `adobe_rgb`,
    R, G and B coded as they are under Adobe APP14 transform 0."""
    H, W = img.shape[:2]
    comps, qtabs, blocks, app = _variant_parts(img, quality, sampling, adobe_rgb)
    hmax, vmax = comps[0][:2]
    out = [synth._headers(app, qtabs, H, W, comps)]
    if restart_interval > 0:
        out.append(synth._segment(0xDD, restart_interval.to_bytes(2, "big")))
    n = len(comps)
    for members in [list(range(n))] if interleaved else [[c] for c in range(n)]:
        if len(members) == 1:       # a lone component codes only the blocks it covers
            h, v, t = comps[members[0]]
            by, bx = _ceil(_ceil(H * v, vmax), 8), _ceil(_ceil(W * h, hmax), 8)
            units = blocks[members[0]][:by, :bx].reshape(-1, 1, 64)
            tabs, comp_of = [t], [0]
        else:
            units = np.concatenate([synth._mcus(blocks[c], *comps[c][:2]) for c in members], 1)
            sizes = [comps[c][0] * comps[c][1] for c in members]
            tabs = np.repeat([comps[c][2] for c in members], sizes)
            comp_of = np.repeat(np.arange(len(members)), sizes)
        out.append(synth._sos([(c, comps[c][2]) for c in members]))
        ri = restart_interval if restart_interval > 0 else len(units)
        for k, start in enumerate(range(0, len(units), ri)):
            if k:
                out.append(bytes([0xFF, 0xD0 + (k - 1) % 8]))
            out.append(synth._entropy_coded(units[start:start + ri], tabs, comp_of))
    return b"".join(out) + b"\xff\xd9"


# ---- the decoder ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(os.listdir(PRINTER)))
def test_printer_jpegs_decode_as_pil(name):
    path = os.path.join(PRINTER, name)
    with Image.open(path) as im:
        assert im.layer == [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]    # 4:2:0
        want = np.asarray(im)
    got = jpeg.read_jpeg(path)
    assert got.shape == want.shape == (378, 504, 3)
    assert np.array_equal(got, want)
    assert jpeg.jpeg_size(path) == common.image_size(path) == (504, 378)


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("wh", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_pil_jpegs_decode_as_pil(wh, subsampling):
    w, h = wh
    img = _seeded((h, w, 3), w * 1000 + h)
    # smooth content beside the noise, so that both AC-heavy and sparse blocks occur
    yy, xx = np.mgrid[:h, :w]
    img[: h // 2] = np.stack([xx * 7, yy * 5, xx + yy], -1)[: h // 2].astype(np.uint8)
    for quality in (50, 95, 100):
        for extra in ({}, {"optimize": True}):
            data = _pil_jpeg(img, quality=quality, subsampling=subsampling, **extra)
            _assert_decodes_as_pil(data, f"{wh} ss{subsampling} q{quality} {extra}")
    for extra in ({"restart_marker_blocks": 1}, {"restart_marker_blocks": 5},
                  {"restart_marker_rows": 1, "optimize": True}):
        data = _pil_jpeg(img, quality=90, subsampling=subsampling, **extra)
        if w * h > 1:
            assert b"\xff\xdd" in data, extra                       # DRI written
        _assert_decodes_as_pil(data, f"{wh} ss{subsampling} {extra}")
    grey = img[..., 1]
    for quality in (50, 95, 100):
        data = _pil_jpeg(grey, quality=quality)
        _assert_decodes_as_pil(data, f"{wh} grey q{quality}")
        assert jpeg.decode_jpeg(data).ndim == 2


@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 2), (1, 1)],
                         ids=["420", "422", "440", "444"])
def test_port_encoder_decodes_as_pil(sampling):
    for w, h in SIZES + [(2, 2), (3, 5), (40, 24)]:
        img = _seeded((h, w, 3), w + 7 * h)
        for extra in ({}, {"restart_interval": 1}, {"restart_interval": 3},
                      {"interleaved": False}, {"interleaved": False, "restart_interval": 2}):
            for quality in (50, 95):
                data = _encode_variant(img, quality, sampling, **extra)
                _assert_decodes_as_pil(data, f"{w}x{h} {sampling} q{quality} {extra}")
        data = _encode_variant(img, 90, sampling, adobe_rgb=True)
        assert b"Adobe" in data and b"JFIF" not in data
        _assert_decodes_as_pil(data, f"{w}x{h} {sampling} adobe rgb")
        for extra in ({}, {"restart_interval": 2}):
            _assert_decodes_as_pil(_encode_variant(img[..., 0], 80, **extra), f"{w}x{h} grey")
        if sampling == (2, 2):      # the port's own writer: the variant's defaults
            for im in (img, img[..., 0]):
                data = synth.encode_jpeg(im, 80)
                assert data == _encode_variant(im, 80)
                _assert_decodes_as_pil(data, f"{w}x{h} encode_jpeg {im.shape}")


def test_fill_bytes_before_markers():
    """0xFF fill bytes before each RSTn and before EOI, and a restart
    interval in each of the subsamplings: decoded as PIL decodes them."""
    img = _seeded((40, 56, 3), 11)
    for subsampling in (0, 1, 2):
        data = _pil_jpeg(img, quality=85, subsampling=subsampling, restart_marker_blocks=2)
        for rst in range(8):
            data = data.replace(bytes([0xFF, 0xD0 + rst]), bytes([0xFF, 0xFF, 0xFF, 0xD0 + rst]))
        data = data[:-2] + b"\xff\xff\xff\xd9"
        assert data.count(b"\xff\xff\xff") > 2
        _assert_decodes_as_pil(data, f"fill bytes ss{subsampling}")


def _coefficient_file(blocks, qtab, H, W) -> bytes:
    """A greyscale baseline JPEG of the given quantised blocks [n, 64]
    (zig-zag, raster order over W x H) under the quantisation table `qtab`
    (natural order; a 16-bit DQT where a value passes 255)."""
    head = synth._headers(synth.JFIF_APP0, [np.ones(64, np.int64)] * 2, H, W, [(1, 1, 0)])
    dqt = head.index(b"\xff\xdb")
    end = dqt + 2 + int.from_bytes(head[dqt + 2:dqt + 4], "big")
    wide = int(qtab.max()) > 255
    table = b"".join(int(v).to_bytes(2 if wide else 1, "big") for v in qtab[synth._ZIGZAG])
    head = head[:dqt] + synth._segment(0xDB, bytes([0x10 if wide else 0]) + table) + head[end:]
    return (head + synth._sos([(0, 0)])
            + synth._entropy_coded(blocks.reshape(-1, 1, 64), [0], [0]) + b"\xff\xd9")


def test_extreme_coefficients_decode_as_pil():
    """Coefficients far past what a photo gives (AC up to +-1023 with 8-
    and 16-bit quantisation tables up to 65535): libjpeg-turbo's x86 SIMD
    IDCT, which PIL runs, dequantises to 16 bits, wraps and saturates its
    16-bit sums where jidctint.c's C arithmetic does not, and saturates
    samples where the C range-limit table wraps; the decoder gives PIL's."""
    rng = np.random.default_rng(5)
    for trial in range(120):
        scale = int(rng.choice([4, 64, 1023]))
        blocks = rng.integers(-scale, scale + 1, (4, 64))
        blocks[:, 0] = rng.integers(-1024, 1024, 4)
        blocks[:, 1:] *= rng.random((4, 63)) < rng.choice([0.0, 0.05, 0.3, 1.0])
        qtab = rng.integers(1, int(rng.choice([2, 100, 256, 4096, 65536])), 64)
        _assert_decodes_as_pil(_coefficient_file(blocks, qtab, 16, 16),
                               f"trial {trial}: |coef| <= {scale}, q <= {qtab.max()}")


def test_port_encoder_scans_equal_libjpeg():
    """On whole MCUs the encoder's entropy-coded data equals PIL's encoder
    (libjpeg's integer DCT, colour conversion and downsampling); only the
    JFIF header differs."""
    for shape in ((32, 48, 3), (64, 64, 3), (32, 32)):
        img = _seeded(shape, shape[1])
        for quality in (50, 95):
            ours, pil = synth.encode_jpeg(img, quality), _pil_jpeg(img, quality=quality)
            assert ours[ours.index(b"\xff\xda"):] == pil[pil.index(b"\xff\xda"):], (shape,
                                                                                  quality)


def test_unsupported_jpegs_raise():
    img = _seeded((24, 40, 3), 3)
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    base = _pil_jpeg(img, quality=90)
    sof = base.index(b"\xff\xc0")
    prog = _pil_jpeg(img, progressive=True)     # progressive decodes; its 12-bit and
    sof2 = prog.index(b"\xff\xc2")              # arithmetic-coded kinds raise
    cases = {                           # file -> (bytes, what the message names)
        "progressive_12bit.jpg": (prog[:sof2 + 4] + b"\x0c" + prog[sof2 + 5:],
                                  "SOF2 (0xFFC2) with 12-bit samples"),
        "progressive_arith.jpg": (prog[:sof2] + b"\xff\xca" + prog[sof2 + 2:],
                                  "SOF10 (0xFFCA, progressive, arithmetic-coded)"),
        "cmyk.jpg": (buf.getvalue(), "CMYK"),
        "arith.jpg": (base[:sof] + b"\xff\xc9" + base[sof + 2:],
                      "SOF9 (0xFFC9, arithmetic-coded)"),
        "12bit.jpg": (base[:sof + 4] + b"\x0c" + base[sof + 5:], "12-bit"),
    }
    for name, (data, what) in cases.items():
        with pytest.raises(ValueError) as e:
            jpeg.decode_jpeg(data, name)
        assert str(e.value).startswith(f"{name}: ") and what in str(e.value), str(e.value)


def _split(data: bytes):
    """A JPEG file as a list of (marker, bytes): every marker segment, and
    each scan as its SOS segment with its entropy-coded data (RSTn
    included)."""
    out, pos = [(0xD8, data[:2])], 2
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xD9:
            out.append((m, data[pos:pos + 2]))
            break
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0x00, *range(0xD0, 0xD8))):
                end += 1
        out.append((m, data[pos:end]))
        pos = end
    return out


def _corrupted(data: bytes, scan: int):
    """{what: file} with scan `scan`'s data damaged as a bad copy or a bad
    encoder damages it: cut in the middle, ending early (the file goes on),
    an RSTn dropped, repeated, or numbered as an earlier, the next or a far
    restart, a flipped bit, junk bytes before the next marker."""
    segs = _split(data)
    at = [i for i, (m, _) in enumerate(segs) if m == 0xDA][scan]
    sos = segs[at][1]
    hdr = 2 + int.from_bytes(sos[2:4], "big")
    head = b"".join(seg for _, seg in segs[:at]) + sos[:hdr]
    body, tail = sos[hdr:], b"".join(seg for _, seg in segs[at + 1:])
    n = len(body)
    out = {"cut": body[:n // 3] + body[2 * n // 3:], "early end": body[:n // 2],
           "junk": body + b"\x12\x34\x00"}
    mid = n // 2
    while mid < n and (body[mid] == 0xFF or body[mid - 1] == 0xFF):
        mid += 1
    if mid < n:
        out["flipped bit"] = body[:mid] + bytes([body[mid] ^ 0x10]) + body[mid + 1:]
    rst = [i for i in range(n - 1) if body[i] == 0xFF and 0xD0 <= body[i + 1] <= 0xD7]
    if len(rst) >= 3:
        i, j, k = rst[:3]
        out["RST dropped"] = body[:i] + body[i + 2:]
        out["RST repeated"] = body[:j] + body[j:j + 2] + body[j:]
        for name, step in (("earlier", -1), ("next", 1), ("far", 4)):
            m = 0xD0 + (body[k + 1] - 0xD0 + step) % 8
            out[f"RST as {name}"] = body[:k + 1] + bytes([m]) + body[k + 2:]
    return {what: head + b + tail for what, b in out.items()}


@pytest.mark.parametrize("restart", [0, 2], ids=["no_restart", "restart2"])
def test_corrupt_scans_decode_as_pil(restart):
    """libjpeg only warns about damaged entropy data, and PIL returns its
    image: once a unit reads past the data, the units after it up to the
    next restart stay zero (mid-grey); a wrong RSTn resyncs as
    jpeg_resync_to_restart does."""
    img = _seeded((40, 56, 3), 8)
    kw = {"restart_marker_blocks": restart} if restart else {}
    for tag, data in (("444", _pil_jpeg(img, quality=80, subsampling=0, **kw)),
                      ("420", _pil_jpeg(img, quality=80, subsampling=2, **kw)),
                      ("grey", _pil_jpeg(img[..., 0], quality=80, **kw))):
        for what, bad in _corrupted(data, 0).items():
            _assert_decodes_as_pil(bad, f"{tag} restart {restart}: {what}")


def test_dc_table_symbol_above_15_raises():
    """A DC Huffman table whose symbol passes 15 (a size category that
    reads more bits than a coefficient has) raises when a scan uses it, as
    libjpeg's table build does, in a baseline and a progressive file."""
    img = _seeded((24, 40, 3), 4)
    for name, data in (("baseline.jpg", _pil_jpeg(img, quality=90)),
                       ("progressive.jpg", _pil_jpeg(img, quality=90, progressive=True))):
        dht = data.index(b"\xff\xc4")
        assert data[dht + 4] >> 4 == 0                     # the first table is a DC table
        vals = dht + 5 + 16
        bad = data[:vals] + bytes([0x60]) + data[vals + 1:]  # its first symbol: 96
        with pytest.raises(OSError):
            Image.open(io.BytesIO(bad)).load()
        with pytest.raises(ValueError) as e:
            jpeg.decode_jpeg(bad, name)
        assert str(e.value).startswith(f"{name}: ") and "symbol above 15" in str(e.value)


def test_jpeg_size_and_image_size_match_pil(tmp_path):
    for i, (w, h) in enumerate(SIZES):
        path = str(tmp_path / f"{i}.jpg")
        Image.fromarray(_seeded((h, w, 3), i)).save(path, progressive=i % 2 == 1)
        with Image.open(path) as im:
            assert jpeg.jpeg_size(path) == common.image_size(path) == im.size


# ---- the resize ---------------------------------------------------------------

RESIZES = [((64, 48), (31, 17)), ((17, 13), (64, 50)), ((100, 1), (7, 1)), ((1, 40), (1, 13)),
           ((1, 1), (5, 3)), ((50, 50), (50, 23)), ((9, 9), (1, 1)), ((5, 7), (13, 3)),
           ((1920, 1056), (960, 640)), ((504, 378), (256, 160)), ((640, 512), (320, 256))]


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_resize_matches_pil(mode):
    ch = {"L": (), "RGB": (3,), "RGBA": (4,)}[mode]
    rng = np.random.default_rng(len(mode))
    for (iw, ih), (ow, oh) in RESIZES:
        img = rng.integers(0, 256, (ih, iw) + ch, dtype=np.uint8)
        if mode == "RGBA":          # alpha 0 and 255 and in between
            img[..., 3] = rng.choice([0, 1, 77, 128, 254, 255], size=(ih, iw))
        for name, filt in (("lanczos", Image.LANCZOS), ("bilinear", Image.BILINEAR)):
            got = resample.resize(img, (ow, oh), name)
            want = np.asarray(Image.fromarray(img, mode).resize((ow, oh), filt))
            assert got.shape == want.shape and np.array_equal(got, want), \
                (mode, (iw, ih), (ow, oh), name)
    img = rng.integers(0, 256, (6, 5) + ch, dtype=np.uint8)
    same = resample.resize(img, (5, 6))
    assert np.array_equal(same, img) and same is not img


# ---- the loaders against the JAX loaders ---------------------------------------

def test_tnt_jpeg_tree_matches_jax(tmp_path):
    """Encoder-made 4:2:0 JPEGs at 136x72, LANCZOS to img_wh 64x32 and
    96x64; intrinsics scaled by the size read from each file's header."""
    synth.write_tnt_tree(str(tmp_path / "tnt"), str(tmp_path / "meta"), 136, 72, n_views=5)
    for wh in ((64, 32), (96, 64)):
        _assert_loaders_equal("tnt", tmp_path / "tnt", f"tnt {wh}", n_views=3, img_wh=wh,
                              nf_mode="minmax", meta_dir=str(tmp_path / "meta"))


def test_llff_jpeg_tree_matches_jax(tmp_path):
    """The LLFF tree's images as PIL JPEGs (4:2:0 and 4:4:4, one
    progressive-free optimised file), resized with LANCZOS."""
    synth.write_llff_tree(str(tmp_path / "llff"), str(tmp_path / "meta"), 96, 48)
    img_dir = tmp_path / "llff" / "scene1" / "images"
    if not img_dir.is_dir():
        img_dir = next(p for p in (tmp_path / "llff").rglob("images") if p.is_dir())
    for i, name in enumerate(sorted(os.listdir(img_dir))):
        png = img_dir / name
        with Image.open(png) as im:
            im.convert("RGB").save(png.with_suffix(".jpg"), quality=90, subsampling=i % 3,
                                   optimize=i == 1)
        os.remove(png)
    _assert_loaders_equal("llff", tmp_path / "llff", "llff jpeg", n_views=3, img_wh=(64, 32),
                          meta_dir=str(tmp_path / "meta"))


def test_dtu_other_img_wh_matches_jax(tmp_path):
    """DTU train samples at img_wh 64x32 from 96x64 PNGs: PIL's BILINEAR."""
    from matchnerf_tpu.data.dtu import DTUDataset as JaxDTU
    from matchnerf_tpu_torch.data.dtu import DTUDataset
    views = (20, 21, 22, 23, 24, 25)
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (len(views), 64, 96, 3), dtype=np.uint8)
    w2cs = np.stack([np.eye(4, dtype=np.float32)] * len(views))
    w2cs[:, 0, 3] = np.arange(len(views), dtype=np.float32) * 0.1
    intrs = np.stack([np.array([[100.0, 0, 48], [0, 100.0, 32], [0, 0, 1]], np.float32)]
                     * len(views))
    synth.write_dtu_tree(str(tmp_path / "DTU"), str(tmp_path / "meta"), images, w2cs, intrs,
                         views, val_view=24)
    kw = dict(n_views=3, img_wh=(64, 32), meta_dir=str(tmp_path / "meta"))
    ours = DTUDataset(str(tmp_path / "DTU"), "train", rng=np.random.default_rng(3), **kw)
    ref = JaxDTU(str(tmp_path / "DTU"), "train", rng=np.random.default_rng(3), **kw)
    assert len(ours) == len(ref) > 0
    for i in (0, 7, len(ours) - 1):     # each read draws the sources from the generator
        got = ours[i]
        _assert_samples_equal(got, ref[i], f"dtu[{i}]")
        assert got["images"].shape == (4, 32, 64, 3)


@pytest.mark.parametrize("img_wh", [(256, 160), (504, 378), (64, 32)])
def test_colmap_printer_matches_jax(img_wh):
    kw = dict(n_views=3, img_wh=img_wh, scene_list=["printer"], test_views_method="fixed",
              nf_mode="minmax")
    root = os.path.join(REPO, "docs", "demo_data")
    mine, theirs = COLMAPDataset(root, "test", **kw), JaxCOLMAP(root, "test", **kw)
    assert len(mine) == len(theirs) == 1
    _assert_samples_equal(mine[0], theirs[0], f"printer {img_wh}")
    assert DATASETS["colmap"] is COLMAPDataset and jdata.datas_dict["colmap"] is JaxCOLMAP


# ---- the constants chip_smoke.py checks on the card ------------------------------

def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_chip_smoke_printer_hashes_match_pil():
    assert sorted(chip_smoke.PRINTER_SHA256) == sorted(os.listdir(PRINTER))
    for name, (decoded, resized) in chip_smoke.PRINTER_SHA256.items():
        with Image.open(os.path.join(PRINTER, name)) as im:
            assert _sha(np.asarray(im)) == decoded, name
            assert _sha(np.asarray(im.resize(chip_smoke.PRINTER_WH, Image.LANCZOS))) == resized
        got = jpeg.read_jpeg(os.path.join(PRINTER, name))
        assert _sha(got) == decoded and _sha(resample.resize(got, chip_smoke.PRINTER_WH)) \
            == resized, name


def test_chip_smoke_roundtrip_hash_matches_pil():
    img = chip_smoke.seeded_photo(*chip_smoke.ROUNDTRIP_WH)
    data = synth.encode_jpeg(img, 95)
    assert _sha(_pil(data)) == chip_smoke.ROUNDTRIP_SHA256
    assert _sha(jpeg.decode_jpeg(data)) == chip_smoke.ROUNDTRIP_SHA256


# ---- no PIL -------------------------------------------------------------------------

def test_port_loads_images_with_pil_blocked(tmp_path):
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['PIL'] = None\n"
        "import matchnerf_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from matchnerf_tpu_torch.data import DATASETS, synth\n"
        f"root, meta = {str(tmp_path / 'tnt')!r}, {str(tmp_path / 'meta')!r}\n"
        "synth.write_tnt_tree(root, meta, 72, 40, n_views=4)\n"
        "s = DATASETS['tnt'](root, 'test', n_views=3, img_wh=(64, 32), meta_dir=meta)[0]\n"
        "assert s['images'].shape == (4, 32, 64, 3), s['images'].shape\n"
        f"p = DATASETS['colmap']({os.path.join(REPO, 'docs', 'demo_data')!r}, 'test', "
        "n_views=3, img_wh=(256, 160), scene_list=['printer'])[0]\n"
        "assert p['images'].shape == (4, 160, 256, 3)\n"
        "import chip_smoke\n"                    # the printer scene re-saved progressive
        f"root = chip_smoke.write_progressive_colmap_tree({str(tmp_path / 'prog')!r})\n"
        "assert chip_smoke.progressive_tree_check(root)['images'] == 4\n"
        "assert chip_smoke.progressive_check()['decoded'] == len(chip_smoke.PROGRESSIVE_SHA256)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'PIL' and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_host_library_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; nothing falls back to PIL."""
    from matchnerf_tpu_torch import hostio
    bad = tmp_path / "image_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(hostio, "SOURCE", bad)
    monkeypatch.setattr(hostio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(hostio, "_lib", None)
    with pytest.raises(RuntimeError, match="host library build failed"):
        hostio.library()
    with pytest.raises(RuntimeError, match="host library build failed"):
        jpeg.read_jpeg(os.path.join(PRINTER, "0.jpeg"))
