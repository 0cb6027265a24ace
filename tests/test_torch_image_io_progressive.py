"""Progressive JPEGs (SOF2) without PIL: the port's decoder (`data/jpeg.py`
over `csrc/image_io.cpp`) against `np.asarray(Image.open(...))` on the CPU,
and the loaders on trees of progressive JPEGs against the JAX loaders. Every
check is bit-equality (`np.array_equal`).

- PIL-written progressive files (libjpeg's simple progression: DC first at
  Al 1, luma AC 1-5 and 6-63 at Al 2, chroma AC at Al 1, then the
  refinement scans) at 1x1, 17x13, 33x65 and 127x96, at 4:4:4, 4:2:2 and
  4:2:0, quality 50, 95 and 100, with restart markers every 1 or 5 blocks
  or every MCU row, and in greyscale.
- The committed fixtures under tests/data/jpeg_progressive/, which the card's
  machine (no PIL) holds to chip_smoke.py's PROGRESSIVE_SHA256.
- Files whose scans stop early, made from PIL files by dropping SOS
  segments: the DC scan only, no refinement scans, no AC scans of Cr. There
  libjpeg-turbo's block smoothing changes the image.
- Each scan repeated once after the last (a bogus progression: libjpeg
  warns and decodes), and scans damaged (cut, ending early, RSTn dropped,
  repeated or misnumbered, a flipped bit, junk bytes: libjpeg warns).
- Malformed scans (Ss > Se, Se != 0 in a DC scan, an AC scan of two
  components, Al != Ah - 1, Al > 13) and a file cut in half raise a
  ValueError that starts with the file's name; PIL raises on each.
- Files PIL does not write, from `_encode_variant`'s pieces with the
  standard tables and EOB0 only (`_encode_progressive`): DC scans
  interleaved or one per component, with and without successive
  approximation, spectral selection in several bands, bands that leave the
  first AC coefficients uncoded (smoothed), 4:4:0, Adobe RGB, restarts.
- The COLMAP (the printer scene re-saved progressive), T&T and LLFF
  loaders on trees of progressive JPEGs against the JAX loaders, every key.
- chip_smoke.py's constants: PROGRESSIVE_SHA256 and the progressive COLMAP
  tree's images at 256x160 (PROGRESSIVE_TREE_SHA256) against PIL.

`PYTHONPATH=. python tests/test_torch_image_io_progressive.py` writes the fixtures anew
with PIL (`write_fixtures`).
"""
import hashlib
import io
import os
import sys

import numpy as np
import pytest
from PIL import Image, ImageFile

from matchnerf_tpu.data.llff import COLMAPDataset as JaxCOLMAP
from matchnerf_tpu_torch.data import common, jpeg, synth
from matchnerf_tpu_torch.data.colmap import COLMAPDataset
from test_torch_datasets import _assert_loaders_equal, _assert_samples_equal
from test_torch_image_io import SIZES, _ceil, _corrupted, _seeded, _split, _variant_parts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

FIXTURES = chip_smoke.PROGRESSIVE_DIR


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _pil_progressive(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", progressive=True, **kw)
    return buf.getvalue()


def _assert_decodes_as_pil(data, tag):
    got, want = jpeg.decode_jpeg(data, tag), _pil(data)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, tag
    assert np.array_equal(got, want), (tag, int(np.abs(got.astype(int) - want).max()))


def _test_image(w, h):
    """A seeded image, smooth in its top half and noise below (the
    decoder tests' pattern in test_torch_image_io.py)."""
    img = _seeded((h, w, 3), w * 1000 + h)
    yy, xx = np.mgrid[:h, :w]
    img[: h // 2] = np.stack([xx * 7, yy * 5, xx + yy], -1)[: h // 2].astype(np.uint8)
    return img


# ---- scans of a file --------------------------------------------------------

def _scan_params(sos: bytes):
    """(component ids, Ss, Se, Ah, Al) of an SOS segment."""
    ns = sos[4]
    ss, se, ahal = sos[5 + 2 * ns:8 + 2 * ns]
    return [sos[5 + 2 * i] for i in range(ns)], ss, se, ahal >> 4, ahal & 15


def _keep_scans(data: bytes, keep) -> bytes:
    """`data` with only the scans for which keep(index, *_scan_params) holds."""
    out, k = [], 0
    for m, seg in _split(data):
        if m == 0xDA:
            k += 1
            if not keep(k - 1, *_scan_params(seg)):
                continue
        out.append(seg)
    return b"".join(out)


def _scans(data: bytes):
    return [seg for m, seg in _split(data) if m == 0xDA]


DC_ONLY = lambda i, comps, ss, se, ah, al: i == 0          # noqa: E731
NO_REFINE = lambda i, comps, ss, se, ah, al: ah == 0        # noqa: E731
NO_CR_AC = lambda i, comps, ss, se, ah, al: not (ss > 0 and comps == [3])  # noqa: E731


# ---- the fixtures -------------------------------------------------------------

def write_fixtures(out_dir=FIXTURES):
    """The committed progressive JPEGs, written with PIL: the three printer
    images re-saved progressive (4:2:0, quality 95), seeded_photo(1920,
    1056) at quality 85, a 4:4:4 file with a restart interval of 3 blocks, a
    greyscale file, and printer_0's scans cut to the DC scan alone and to
    the scans before the refinements."""
    os.makedirs(out_dir, exist_ok=True)
    files = {}
    for i in range(3):
        with Image.open(os.path.join(chip_smoke.PRINTER_DIR, f"{i}.jpeg")) as im:
            files[f"printer_{i}.jpg"] = _pil_progressive(np.asarray(im), quality=95,
                                                         subsampling=2)
    w, h = chip_smoke.ROUNDTRIP_WH
    files[f"photo_{w}x{h}.jpg"] = _pil_progressive(chip_smoke.seeded_photo(w, h), quality=85)
    files["restart_444.jpg"] = _pil_progressive(chip_smoke.seeded_photo(160, 120, seed=1),
                                                quality=90, subsampling=0,
                                                restart_marker_blocks=3)
    files["grey.jpg"] = _pil_progressive(chip_smoke.seeded_photo(200, 150, seed=2)[..., 1],
                                         quality=90)
    files["printer_0_dc_only.jpg"] = _keep_scans(files["printer_0.jpg"], DC_ONLY)
    files["printer_0_no_refine.jpg"] = _keep_scans(files["printer_0.jpg"], NO_REFINE)
    for name, data in files.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
    return sorted(files)


# ---- PIL-written files ----------------------------------------------------------

@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("wh", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_pil_progressive_decode_as_pil(wh, subsampling):
    w, h = wh
    img = _test_image(w, h)
    for quality in (50, 95, 100):
        data = _pil_progressive(img, quality=quality, subsampling=subsampling)
        assert b"\xff\xc2" in data and len(_scans(data)) == 10
        _assert_decodes_as_pil(data, f"{wh} ss{subsampling} q{quality}")
    for extra in ({"restart_marker_blocks": 1}, {"restart_marker_blocks": 5},
                  {"restart_marker_rows": 1}):
        data = _pil_progressive(img, quality=90, subsampling=subsampling, **extra)
        if w * h > 1:
            assert b"\xff\xdd" in data, extra
        _assert_decodes_as_pil(data, f"{wh} ss{subsampling} {extra}")
    if subsampling == 0:
        for quality in (50, 95, 100):
            data = _pil_progressive(img[..., 1], quality=quality)
            _assert_decodes_as_pil(data, f"{wh} grey q{quality}")
            assert jpeg.decode_jpeg(data).ndim == 2


@pytest.mark.parametrize("name", sorted(chip_smoke.PROGRESSIVE_SHA256))
def test_fixtures_decode_as_pil(name):
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    assert b"\xff\xc2" in data
    got = jpeg.read_jpeg(path)
    with Image.open(path) as im:
        want = np.asarray(im)
        assert jpeg.jpeg_size(path) == common.image_size(path) == im.size
    assert got.shape == want.shape and np.array_equal(got, want), name


def test_fixtures_are_small_and_complete():
    names = sorted(os.listdir(FIXTURES))
    assert names == sorted(chip_smoke.PROGRESSIVE_SHA256)
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names) < 600_000
    with open(os.path.join(FIXTURES, "restart_444.jpg"), "rb") as f:
        assert b"\xff\xdd" in f.read()
    for name, n_scans in (("printer_0.jpg", 10), ("printer_0_dc_only.jpg", 1),
                          ("printer_0_no_refine.jpg", 5)):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert len(_scans(f.read())) == n_scans, name


# ---- scans that stop early, repeat, or are malformed ------------------------------

@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_early_stopping_files_decode_as_pil(subsampling):
    """Block smoothing: every DC partly known, some of the first AC
    coefficients not exact. 33x65 and 9x17 end in a half-filled MCU row at
    4:2:0 (the smoothing reads the padding blocks' DC there)."""
    for w, h in ((17, 13), (33, 65), (127, 96), (9, 17), (40, 24)):
        img = _test_image(w, h)
        for quality in (50, 95):
            data = _pil_progressive(img, quality=quality, subsampling=subsampling)
            for tag, keep in (("dc only", DC_ONLY), ("no refinement", NO_REFINE),
                              ("no Cr AC", NO_CR_AC)):
                _assert_decodes_as_pil(_keep_scans(data, keep),
                                       f"{w}x{h} ss{subsampling} q{quality} {tag}")
        if subsampling == 0:
            grey = _pil_progressive(img[..., 0], quality=90)
            for tag, keep in (("dc only", DC_ONLY), ("no refinement", NO_REFINE)):
                _assert_decodes_as_pil(_keep_scans(grey, keep), f"{w}x{h} grey {tag}")


@pytest.mark.parametrize("subsampling", [0, 2], ids=["444", "420"])
def test_repeated_scan_decodes_as_pil(subsampling):
    """Each scan once more before EOI, under the Huffman tables the last
    scans left: a refinement applied twice, an AC first scan over refined
    coefficients. The bits fall out of step, so codes past 16 bits (17 bits
    and a zero, as libjpeg takes them), data run out mid-scan (the rows
    after it smoothed with the Al from before the scan) and coefficients
    past the IDCT's 16-bit range (PIL's SIMD IDCT saturates) all occur."""
    data = _pil_progressive(_test_image(40, 24), quality=50, subsampling=subsampling)
    for k, scan in enumerate(_scans(data)):
        _assert_decodes_as_pil(data[:-2] + scan + b"\xff\xd9", f"ss{subsampling} scan {k} twice")


@pytest.mark.parametrize("scan", [0, 1, 5, 6, 9], ids=["dc", "ac", "ac_refine", "dc_refine",
                                                   "last"])
def test_corrupt_scans_decode_as_pil(scan):
    """A damaged scan (`_corrupted`) decodes as PIL decodes it: the units
    after the data runs out are left as they were until the next restart,
    and with them the rows smoothing reads with the Al from before the
    scan; a wrong RSTn resyncs as jpeg_resync_to_restart does."""
    img = _test_image(40, 24)
    for subsampling in (0, 2):
        for kw in ({}, {"restart_marker_blocks": 2}):
            data = _pil_progressive(img, quality=80, subsampling=subsampling, **kw)
            for what, bad in _corrupted(data, scan).items():
                _assert_decodes_as_pil(bad, f"ss{subsampling} {kw} scan {scan}: {what}")


def _with_scan_header(data: bytes, k: int, comps=None, ss=None, se=None, ah=None, al=None):
    """`data` with scan k's SOS header rewritten (its entropy data kept)."""
    out, i = [], 0
    for m, seg in _split(data):
        if m == 0xDA:
            if i == k:
                old, (c0, s0, e0, h0, l0) = seg[4:5 + 2 * seg[4]], _scan_params(seg)
                tabs = {old[1 + 2 * j]: old[2 + 2 * j] for j in range(old[0])}
                comps = c0 if comps is None else comps
                body = bytes([len(comps)]) + b"".join(bytes([c, tabs.get(c, 0x11)])
                                                      for c in comps)
                body += bytes([s0 if ss is None else ss, e0 if se is None else se,
                               ((h0 if ah is None else ah) << 4) | (l0 if al is None else al)])
                seg = synth._segment(0xDA, body) + seg[2 + int.from_bytes(seg[2:4], "big"):]
            i += 1
        out.append(seg)
    return b"".join(out)


def test_malformed_progressive_raise():
    data = _pil_progressive(_test_image(40, 24), quality=90)
    # scans: 0 DC first (Al 1), 1 Y AC 1-5, 2 Cr, 3 Cb, 4 Y AC 6-63, 5 Y AC
    # refinement (Ah 2, Al 1), 6 DC refinement, 7-9 AC refinements
    cases = {                           # file -> (bytes, what the message names)
        "ss_gt_se.jpg": (_with_scan_header(data, 1, ss=9, se=5),
                         "scan 2 (Ss 9, Se 5, Ah 0, Al 2): bad progression: Ss > Se"),
        "dc_se.jpg": (_with_scan_header(data, 0, se=1), "scan 1 (Ss 0, Se 1, Ah 0, Al 1)"),
        "ac_two.jpg": (_with_scan_header(data, 2, comps=[2, 3]),
                       "scan 3 (Ss 1, Se 63, Ah 0, Al 1): bad progression: an AC scan names "
                       "more than one component"),
        "ah_al.jpg": (_with_scan_header(data, 5, ah=2, al=0), "Al != Ah - 1"),
        "al_14.jpg": (_with_scan_header(data, 1, al=14), "Al > 13"),
        "half.jpg": (data[:len(data) // 2], "truncated file"),
    }
    for name, (bad, what) in cases.items():
        with pytest.raises(OSError):
            Image.open(io.BytesIO(bad)).load()
        with pytest.raises(ValueError) as e:
            jpeg.decode_jpeg(bad, name)
        assert str(e.value).startswith(f"{name}: ") and what in str(e.value), str(e.value)


# ---- files PIL does not write ---------------------------------------------------

def _sos(members, ss, se, ah, al) -> bytes:
    """A progressive scan's SOS segment: (component index, table set) each."""
    body = bytes([len(members)]) + b"".join(bytes([ci + 1, (t << 4) | t]) for ci, t in members)
    return synth._segment(0xDA, body + bytes([ss, se, (ah << 4) | al]))


def _coded(units, restart_interval) -> bytes:
    """Entropy-coded bytes of `units` (the (value, length) tokens of each
    MCU), RSTn after every restart_interval units."""
    ri = restart_interval or len(units) or 1
    out = []
    for k, start in enumerate(range(0, len(units), ri)):
        if k:
            out.append(bytes([0xFF, 0xD0 + (k - 1) % 8]))
        toks = [t for u in units[start:start + ri] for t in u]
        out.append(synth._pack(np.array([v for v, _ in toks], np.int64),
                               np.array([n for _, n in toks], np.int64)))
    return b"".join(out)


def _encode_progressive(img, quality, sampling=(2, 2), adobe_rgb=False, dc_interleaved=True,
                        dc_al=0, bands=((1, 5), (6, 63)), restart_interval=0) -> bytes:
    """A progressive JPEG (SOF2) of a kind PIL does not write, from
    `_encode_variant`'s pieces, the standard Huffman tables and EOB0 only:
    the DC first scan at point transform dc_al (all components interleaved,
    or one scan each), its refinement scan when dc_al is 1, then for each
    component one AC first scan per band (Ss, Se) of `bands` at Al 0."""
    H, W = img.shape[:2]
    comps, qtabs, blocks, app = _variant_parts(img, quality, sampling, adobe_rgb)
    hmax, vmax = comps[0][:2]
    head = synth._headers(app, qtabs, H, W, comps)    # SOI, APPn, DQT, SOF0, DHT
    dqt = 2 + len(app)
    sof = dqt + 2 + int.from_bytes(head[dqt + 2:dqt + 4], "big")
    assert head[sof:sof + 2] == b"\xff\xc0"
    out = [head[:sof] + b"\xff\xc2" + head[sof + 2:]]
    if restart_interval:
        out.append(synth._segment(0xDD, restart_interval.to_bytes(2, "big")))
    codes = [synth._huff_codes(*spec) for spec in synth._HUFF_SPECS]

    def own(c):                         # a lone component codes only the blocks it covers
        h, v, _ = comps[c]
        return blocks[c][:_ceil(_ceil(H * v, vmax), 8), :_ceil(_ceil(W * h, hmax), 8)]

    def dc_scan(members, refine):
        if len(members) == 1:
            units = [[(members[0], b)] for b in own(members[0]).reshape(-1, 64)]
        else:
            mcus = [synth._mcus(blocks[c], *comps[c][:2]) for c in members]
            units = [[(c, b) for c, m in zip(members, mcus) for b in m[u]]
                     for u in range(len(mcus[0]))]
        ri = restart_interval or len(units)
        toks, pred = [], {}
        for u, unit in enumerate(units):
            if u % ri == 0:
                pred = dict.fromkeys(members, 0)
            t = []
            for c, b in unit:
                if refine:
                    t.append((int(b[0]) & 1, 1))
                    continue
                dc = int(b[0]) >> dc_al
                s, extra = (int(x) for x in synth._magnitude(np.array(dc - pred[c])))
                code, n = codes[comps[c][2]][0][s], codes[comps[c][2]][1][s]
                t.append(((int(code) << s) | extra, int(n) + s))
                pred[c] = dc
            toks.append(t)
        out.append(_sos([(c, comps[c][2]) for c in members], 0, 0, int(refine),
                        0 if refine else dc_al))
        out.append(_coded(toks, restart_interval))

    def ac_scan(c, ss, se):
        code, length = codes[2 + comps[c][2]]
        toks = []
        for b in own(c).reshape(-1, 64):
            t, run = [], 0
            for k in range(ss, se + 1):
                if b[k] == 0:
                    run += 1
                    continue
                for _ in range(run // 16):                     # ZRL
                    t.append((int(code[0xF0]), int(length[0xF0])))
                s, extra = (int(x) for x in synth._magnitude(np.array(b[k])))
                sym = ((run % 16) << 4) | s
                t.append(((int(code[sym]) << s) | extra, int(length[sym]) + s))
                run = 0
            if run:                                            # EOB0
                t.append((int(code[0]), int(length[0])))
            toks.append(t)
        out.append(_sos([(c, comps[c][2])], ss, se, 0, 0))
        out.append(_coded(toks, restart_interval))

    groups = [list(range(len(comps)))] if dc_interleaved else [[c] for c in range(len(comps))]
    for members in groups:
        dc_scan(members, False)
    for c in range(len(comps)):
        for ss, se in bands:
            ac_scan(c, ss, se)
    if dc_al:
        for members in groups:
            dc_scan(members, True)
    return b"".join(out) + b"\xff\xd9"


VARIANTS = {
    "dc_separate": dict(dc_interleaved=False),
    "spectral_only": dict(bands=((1, 2), (3, 9), (10, 63))),
    "one_band": dict(bands=((1, 63),), restart_interval=2),
    "dc_refined": dict(dc_al=1, restart_interval=3),
    "dc_separate_refined": dict(dc_interleaved=False, dc_al=1),
    "no_first_ac": dict(bands=((3, 63),)),             # AC 1 and 2 never coded: smoothed
    "low_band_only": dict(bands=((1, 5),), dc_interleaved=False),
    "adobe_rgb": dict(adobe_rgb=True),
}


@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 2), (1, 1)],
                         ids=["420", "422", "440", "444"])
def test_port_encoder_progressive_decode_as_pil(sampling):
    for w, h in ((17, 13), (33, 65), (40, 24)):
        img = _test_image(w, h)
        for name, kw in VARIANTS.items():
            data = _encode_progressive(img, 80, sampling, **kw)
            assert (b"Adobe" in data) == (name == "adobe_rgb")
            _assert_decodes_as_pil(data, f"{w}x{h} {sampling} {name}")
        if sampling == (2, 2):
            for kw in (dict(), dict(dc_al=1, restart_interval=2), dict(bands=((3, 63),))):
                _assert_decodes_as_pil(_encode_progressive(img[..., 0], 70, **kw),
                                       f"{w}x{h} grey {kw}")


# ---- the loaders on progressive trees --------------------------------------------

def test_colmap_progressive_printer_matches_jax(tmp_path):
    """The printer scene with its images re-saved progressive (the fixtures),
    as chip_smoke.py writes it."""
    root = chip_smoke.write_progressive_colmap_tree(str(tmp_path))
    for img_wh in (chip_smoke.PRINTER_WH, (504, 378)):
        kw = dict(n_views=3, img_wh=img_wh, scene_list=["printer"],
                  test_views_method="fixed", nf_mode="minmax")
        mine, theirs = COLMAPDataset(root, "test", **kw), JaxCOLMAP(root, "test", **kw)
        assert len(mine) == len(theirs) == 1
        _assert_samples_equal(mine[0], theirs[0], f"progressive printer {img_wh}")


def test_tnt_progressive_tree_matches_jax(tmp_path):
    """The T&T tree's JPEGs re-saved progressive by PIL, larger than img_wh."""
    root, meta = tmp_path / "tnt", tmp_path / "meta"
    synth.write_tnt_tree(str(root), str(meta), 136, 72, n_views=4)
    img_dir = root / "Truck" / "images"
    for i, name in enumerate(sorted(os.listdir(img_dir))):
        with Image.open(img_dir / name) as im:
            data = _pil_progressive(np.asarray(im), quality=90, subsampling=i % 3)
        (img_dir / name).write_bytes(data)
    _assert_loaders_equal("tnt", root, "tnt progressive", n_views=3, img_wh=(64, 32),
                          nf_mode="minmax", meta_dir=str(meta))


def test_llff_progressive_tree_matches_jax(tmp_path):
    """The LLFF tree's PNGs as progressive JPEGs (4:2:0, 4:4:4, restarts,
    one with its refinement scans dropped), resized with LANCZOS."""
    root, meta = tmp_path / "llff", tmp_path / "meta"
    synth.write_llff_tree(str(root), str(meta), 96, 48)
    img_dir = root / "fern" / "images"
    for i, name in enumerate(sorted(os.listdir(img_dir))):
        png = img_dir / name
        with Image.open(png) as im:
            data = _pil_progressive(np.asarray(im.convert("RGB")), quality=90,
                                    subsampling=(2, 0)[i % 2], restart_marker_rows=i % 3 == 1)
        if i == 3:
            data = _keep_scans(data, NO_REFINE)
        png.with_suffix(".jpg").write_bytes(data)
        os.remove(png)
    _assert_loaders_equal("llff", root, "llff progressive", n_views=3, img_wh=(64, 32),
                          meta_dir=str(meta))


# ---- the constants chip_smoke.py checks on the card ---------------------------------

def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_chip_smoke_progressive_hashes_match_pil(tmp_path):
    for name, want in chip_smoke.PROGRESSIVE_SHA256.items():
        path = os.path.join(FIXTURES, name)
        with Image.open(path) as im:
            assert _sha(np.asarray(im)) == want, name
    assert chip_smoke.progressive_check()["decoded"] == len(chip_smoke.PROGRESSIVE_SHA256)
    root = chip_smoke.write_progressive_colmap_tree(str(tmp_path))
    for name, want in chip_smoke.PROGRESSIVE_TREE_SHA256.items():
        with Image.open(os.path.join(FIXTURES, name)) as im:
            assert _sha(np.asarray(im.resize(chip_smoke.PRINTER_WH, Image.LANCZOS))) == want
    assert chip_smoke.progressive_tree_check(root)["images"] == 4


if __name__ == "__main__":
    ImageFile.MAXBLOCK = max(ImageFile.MAXBLOCK, 1 << 22)
    for fixture in write_fixtures():
        print(os.path.join(FIXTURES, fixture))
