"""The port's file readers and resizes against the JAX package's.

- NIfTI, NRRD and DICOM: the byte-built fixtures of tests/test_format_spec.py
  (the specifications' field offsets) and their adversarial variants give
  exactly the JAX readers' arrays, or the same ValueError; so do seeded byte
  mutations of each.
- PNG: ``read_mask`` and ``read_image_rgb`` equal the JAX reader's (Pillow's
  ``convert``) output exactly for every colour type and bit depth up to 8,
  each row filter, and Pillow-written files; 16-bit and interlaced files
  raise ValueError.
- Resize: ``resize_image`` (bilinear) and ``resize_mask`` (nearest) equal
  the JAX versions (Pillow) bit for bit at upscales, downscales at
  non-integer ratios and identity, on random uint8 content with 0 and 255.
"""

import gzip
import struct
import zlib

import numpy as np
import pytest
from test_format_spec import (
    _dicom_element_explicit,
    _dicom_element_implicit,
    _implicit_vr_dicom,
    _nifti_bytes,
    _xyz_payload,
)

from aide_tpu.data.io import dicom as jdicom
from aide_tpu.data.io import nifti as jnifti
from aide_tpu.data.io import nrrd as jnrrd
from aide_tpu.data.io import png as jpng
from aide_tpu.data.tasks import base as jbase

from aide_tpu_torch.data.io import dicom, nifti, nrrd, png
from aide_tpu_torch.data.tasks import base


def _nrrd(lines, payload=b""):
    return ("\n".join(lines) + "\n\n").encode() + payload


def _with(blob, fmt, offset, *values):
    out = bytearray(blob)
    struct.pack_into(fmt, out, offset, *values)
    return bytes(out)


def _gz_rot(blob):
    whole = bytearray(gzip.compress(blob))
    for i in range(20, min(60, len(whole) - 9)):
        whole[i] ^= 0xA5
    return bytes(whole)


_NII = _nifti_bytes(3, 2, 4)
NIFTI_CASES = {
    "le_int16": _NII,
    "big_endian": _nifti_bytes(3, 2, 4, end=">"),
    "scl_slope_inter": _nifti_bytes(3, 2, 4, scl_slope=2.0, scl_inter=-1.0),
    "nan_slope": _nifti_bytes(3, 2, 4, scl_slope=float("nan"), scl_inter=float("nan")),
    "gzip": gzip.compress(_NII),
    "vox_offset_368": _nifti_bytes(3, 2, 4, vox_offset=368.0),
    "uint8": _nifti_bytes(3, 2, 4, datatype=2, bitpix=8, dtype=np.uint8),
    "oblique_orientation": _with(_with(_NII, "<h", 252, 1), "<6f", 256, 0.7, 0.1, -0.7, 12.0, -30.0, 4.4),
    "bad_magic": _nifti_bytes(3, 2, 4, magic=b"xx1\x00"),
    "vox_offset_into_header": _with(_NII, "<f", 108, 100.0),
    "vox_offset_348": _with(_NII, "<f", 108, 348.0),
    "vox_offset_negative": _with(_NII, "<f", 108, -4.0),
    "vox_offset_nan": _with(_NII, "<f", 108, float("nan")),
    "dim0_zero": _with(_NII, "<8h", 40, 0, 3, 2, 4, 1, 1, 1, 1),
    "dim0_eight": _with(_NII, "<8h", 40, 8, 3, 2, 4, 1, 1, 1, 1),
    "negative_dim": _with(_NII, "<8h", 40, 3, 3, -2, 4, 1, 1, 1, 1),
    "truncated_payload": _NII[:-10],
    "truncated_gzip": gzip.compress(_NII)[: len(gzip.compress(_NII)) // 2],
    "corrupt_deflate": _gz_rot(_NII),
}

_HDR = ["NRRD0004", "type: short", "dimension: 3", "sizes: 3 2 4"]
NRRD_CASES = {
    "raw_short": _nrrd(_HDR + ["# comment", "space: left-posterior-superior", "endian: little",
                               "encoding: raw"], _xyz_payload(3, 2, 4, np.int16)),
    "gzip_uchar": _nrrd(["NRRD0004", "type: unsigned char", "dimension: 3", "sizes: 3 2 4",
                         "encoding: gzip"], gzip.compress(_xyz_payload(3, 2, 4, np.uint8))),
    "big_endian": _nrrd(_HDR + ["endian: big", "encoding: raw"], _xyz_payload(3, 2, 4, np.int16, end=">")),
    "crlf": ("NRRD0004\r\ntype: uchar\r\ndimension: 3\r\nsizes: 3 2 4\r\nencoding: raw\r\n\r\n").encode()
    + _xyz_payload(3, 2, 4, np.uint8),
    "float": _nrrd(["NRRD0004", "type: float", "dimension: 3", "sizes: 3 2 4", "encoding: raw"],
                   _xyz_payload(3, 2, 4, np.float32)),
    "byte_skip": _nrrd(["NRRD0004", "type: uchar", "dimension: 3", "sizes: 3 2 4", "encoding: raw",
                        "byte skip: 5"], b"JUNK!" + _xyz_payload(3, 2, 4, np.uint8)),
    "byte_skip_tail": _nrrd(["NRRD0004", "type: uchar", "dimension: 3", "sizes: 3 2 4",
                             "encoding: raw", "byte skip: -1"], b"\x00" * 17 + _xyz_payload(3, 2, 4, np.uint8)),
    "byte_skip_gzip": _nrrd(["NRRD0004", "type: uchar", "dimension: 3", "sizes: 3 2 4",
                             "encoding: gzip", "byte skip: 3"],
                            b"xyz" + gzip.compress(_xyz_payload(3, 2, 4, np.uint8))),
    "not_nrrd": b"PNG\n\n",
    "detached": _nrrd(_HDR + ["encoding: raw", "data file: ./volume.raw"]),
    "line_skip": _nrrd(_HDR + ["encoding: raw", "line skip: 2"], _xyz_payload(3, 2, 4, np.int16)),
    "no_sizes": _nrrd(["NRRD0004", "type: uchar", "encoding: raw"], b"\x00" * 24),
    "negative_sizes": _nrrd(["NRRD0004", "type: uchar", "sizes: 3 -2 4", "encoding: raw"], b"\x00" * 24),
    "block_type": _nrrd(["NRRD0004", "type: block", "sizes: 3 2 4", "encoding: raw"], b"\x00" * 288),
    "truncated_gzip": _nrrd(_HDR + ["encoding: gzip"],
                            gzip.compress(_xyz_payload(3, 2, 4, np.int16))[:20]),
    "short_raw": _nrrd(_HDR + ["encoding: raw"], _xyz_payload(3, 2, 4, np.int16)[:-6]),
}


def _explicit_vr_dicom(rows=4, cols=3, signed=False):
    meta = _dicom_element_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1\x00")
    pixels = (np.arange(rows * cols) * 97 - (500 if signed else 0)).astype(np.int16 if signed else np.uint16)
    body = b"".join([
        _dicom_element_explicit(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _dicom_element_explicit(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _dicom_element_explicit(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        _dicom_element_explicit(0x0028, 0x0103, b"US", struct.pack("<H", int(signed))),
        _dicom_element_explicit(0x0028, 0x0030, b"DS", b"0.7\\0.8 "),
        _dicom_element_explicit(0x0028, 0x1053, b"DS", b"1.5 "),
        _dicom_element_explicit(0x0018, 0x0050, b"DS", b"3.0 "),
        _dicom_element_explicit(0x7FE0, 0x0010, b"OW", pixels.tobytes()),
    ])
    return b"\x00" * 128 + b"DICM" + meta + body


def _multiframe():
    meta = _dicom_element_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2\x00")
    body = b"".join([
        _dicom_element_implicit(0x0028, 0x0010, struct.pack("<H", 4)),
        _dicom_element_implicit(0x0028, 0x0011, struct.pack("<H", 3)),
        _dicom_element_implicit(0x0028, 0x0100, struct.pack("<H", 16)),
        _dicom_element_implicit(0x0028, 0x0008, b"2 "),
        _dicom_element_implicit(0x7FE0, 0x0010, np.arange(24, dtype=np.uint16).tobytes()),
    ])
    return b"\x00" * 128 + b"DICM" + meta + body


DICOM_CASES = {
    "implicit_vr": _implicit_vr_dicom()[0],
    "explicit_vr": _explicit_vr_dicom(),
    "explicit_vr_signed": _explicit_vr_dicom(5, 2, signed=True),
    "jpeg_syntax": _explicit_vr_dicom().replace(b"1.2.840.10008.1.2.1\x00", b"1.2.840.10008.1.2.4.5"),
    "multiframe": _multiframe(),
    "truncated": _implicit_vr_dicom()[0][:-7],
    "not_dicom": b"\x00" * 140,
}


def _outcome(fn):
    """('ok', value) or ('raise', exception type name, message)."""
    try:
        return ("ok", fn())
    except (ValueError, KeyError, TypeError) as e:
        return ("raise", type(e).__name__, str(e))


def _same(got, want):
    assert got[0] == want[0], (got, want)
    if got[0] == "raise":
        assert got[1:] == want[1:]
        return
    for g, w in zip(got[1], want[1]):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _read_volume(mod, path):
    if mod in (nifti, jnifti):
        return (mod.read_nifti(path),)
    arr, header = mod.read_nrrd(path)
    return arr, header


def _read_dicom(mod, path):
    d = mod.read_dicom(path)
    return d.tags, d.pixel_array, d.rescaled_array, d.pixel_spacing


@pytest.mark.parametrize("name", sorted(NIFTI_CASES))
def test_nifti_matches_jax(tmp_path, name):
    path = str(tmp_path / ("v.nii.gz" if name.startswith(("gzip", "trunc", "corrupt")) else "v.nii"))
    with open(path, "wb") as fh:
        fh.write(NIFTI_CASES[name])
    _same(_outcome(lambda: _read_volume(nifti, path)), _outcome(lambda: _read_volume(jnifti, path)))


@pytest.mark.parametrize("name", sorted(NRRD_CASES))
def test_nrrd_matches_jax(tmp_path, name):
    path = str(tmp_path / "v.nrrd")
    with open(path, "wb") as fh:
        fh.write(NRRD_CASES[name])
    _same(_outcome(lambda: _read_volume(nrrd, path)), _outcome(lambda: _read_volume(jnrrd, path)))


@pytest.mark.parametrize("name", sorted(DICOM_CASES))
def test_dicom_matches_jax(tmp_path, name):
    path = str(tmp_path / "v.dcm")
    with open(path, "wb") as fh:
        fh.write(DICOM_CASES[name])
    _same(_outcome(lambda: _read_dicom(dicom, path)), _outcome(lambda: _read_dicom(jdicom, path)))


@pytest.mark.parametrize("kind", ["nifti", "nrrd", "dicom"])
def test_byte_fuzz_matches_jax(tmp_path, kind):
    """Seeded 1-3 byte mutations of a valid file: both packages decode the
    same array or raise the same error."""
    base = {"nifti": _NII, "nrrd": NRRD_CASES["raw_short"], "dicom": DICOM_CASES["implicit_vr"]}[kind]
    read = {"nifti": _read_volume, "nrrd": _read_volume, "dicom": _read_dicom}[kind]
    mods = {"nifti": (nifti, jnifti), "nrrd": (nrrd, jnrrd), "dicom": (dicom, jdicom)}[kind]
    rng = np.random.default_rng(7)
    path = str(tmp_path / f"fuzz.{kind}")
    for _ in range(60):
        blob = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))
        with open(path, "wb") as fh:
            fh.write(bytes(blob))
        _same(_outcome(lambda: read(mods[0], path)), _outcome(lambda: read(mods[1], path)))


def test_writers_round_trip_through_jax(tmp_path):
    vol = np.random.default_rng(0).integers(0, 900, (3, 5, 7)).astype(np.int16)
    nifti.write_nifti(str(tmp_path / "a.nii.gz"), vol)
    nrrd.write_nrrd(str(tmp_path / "a.nrrd"), vol)
    np.testing.assert_array_equal(jnifti.read_nifti(str(tmp_path / "a.nii.gz")), vol)
    np.testing.assert_array_equal(jnrrd.read_nrrd(str(tmp_path / "a.nrrd"))[0], vol)


# ------------------------------- PNG -------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_bytes(samples, colour, depth, filt, palette=None, interlace=0):
    """A PNG of (H, W, S) samples, every row under filter ``filt`` (or
    filters 0-4 in turn for "mixed")."""
    h, w, s = samples.shape
    if depth < 8:
        flat = samples.reshape(h, w * s)[..., None] >> np.arange(depth - 1, -1, -1)
        rows = np.packbits((flat & 1).astype(np.uint8).reshape(h, -1), axis=1)
    else:
        rows = samples.reshape(h, -1).astype(">u2" if depth == 16 else np.uint8).view(np.uint8).reshape(h, -1)
    bpp = max(1, s * depth // 8)
    out, prev = bytearray(), [0] * rows.shape[1]
    for y in range(h):
        line, f = rows[y].tolist(), (y % 5 if filt == "mixed" else filt)
        enc = []
        for x, v in enumerate(line):
            a = line[x - bpp] if x >= bpp else 0
            c = prev[x - bpp] if x >= bpp else 0
            enc.append((v - [0, a, prev[x], (a + prev[x]) >> 1, _paeth(a, prev[x], c)][f]) & 0xFF)
        out += bytes([f] + enc)
        prev = line

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    blob = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if palette is not None:
        blob += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return blob + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")


PNG_MODES = [(0, 1), (0, 2), (0, 4), (0, 8), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (2, 8), (6, 8)]


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("colour,depth", PNG_MODES)
def test_read_png_matches_pillow(tmp_path, colour, depth, filt):
    rng = np.random.default_rng(colour * 100 + depth)
    samples_n = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    palette = None
    if colour == 3:
        palette = rng.integers(0, 256, (1 << depth, 3))
        samples = rng.integers(0, 1 << depth, (7, 13, 1))
    else:
        samples = rng.integers(0, 1 << depth, (7, 13, samples_n))
        samples[0, 0], samples[-1, -1] = 0, (1 << depth) - 1
    path = str(tmp_path / "m.png")
    with open(path, "wb") as fh:
        fh.write(_png_bytes(samples, colour, depth, filt, palette))
    np.testing.assert_array_equal(png.read_mask(path), jpng.read_mask(path))
    np.testing.assert_array_equal(png.read_image_rgb(path), jpng.read_image_rgb(path))


@pytest.mark.parametrize("mode", ["1", "L", "P", "LA", "RGB", "RGBA"])
def test_read_pillow_written_png(tmp_path, mode):
    """Files Pillow writes itself (adaptive filters, its palette layout)."""
    from PIL import Image

    rng = np.random.default_rng(3)
    if mode in ("1", "L", "P"):
        img = Image.fromarray(rng.integers(0, 256, (40, 37)).astype(np.uint8), "L").convert(mode)
    else:
        img = Image.fromarray(rng.integers(0, 256, (40, 37, len(mode))).astype(np.uint8), mode)
    path = str(tmp_path / "p.png")
    img.save(path)
    np.testing.assert_array_equal(png.read_mask(path), jpng.read_mask(path))
    np.testing.assert_array_equal(png.read_image_rgb(path), jpng.read_image_rgb(path))


@pytest.mark.parametrize("case", ["16-bit gray", "16-bit RGB", "interlaced"])
def test_read_png_refuses(tmp_path, case):
    samples = np.random.default_rng(0).integers(0, 200, (4, 5, 3 if "RGB" in case else 1))
    depth = 16 if "16" in case else 8
    blob = _png_bytes(samples, 2 if "RGB" in case else 0, depth, 0, interlace=int(case == "interlaced"))
    path = str(tmp_path / "x.png")
    with open(path, "wb") as fh:
        fh.write(blob)
    with pytest.raises(ValueError, match="16-bit" if depth == 16 else "interlaced"):
        png.read_mask(path)


def test_write_mask_reads_back_in_pillow(tmp_path):
    mask = (np.random.default_rng(1).random((9, 11)) > 0.5).astype(np.uint8)
    path = str(tmp_path / "w.png")
    png.write_mask(path, mask, scale=255)
    np.testing.assert_array_equal(jpng.read_mask(path), mask * 255)


# ------------------------------ resize ------------------------------

RESIZES = [(320, 256), (512, 384), (497, 512), (33, 32), (32, 33), (256, 384), (40, 32), (7, 64), (64, 64)]


def _content(rng, shape):
    u8 = rng.integers(0, 256, shape).astype(np.uint8)
    u8.flat[0], u8.flat[-1] = 0, 255
    return u8


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_image_matches_pillow(src, dst):
    rng = np.random.default_rng(src * 1000 + dst)
    rgb = _content(rng, (src, src, 3))
    gray = np.repeat(_content(rng, (src, src, 1)), 3, axis=2)
    for img in (rgb, gray, np.where(rgb > 127, 255, 0)):
        got = base.resize_image(img.astype(np.float32), dst)
        want = jbase.resize_image(img.astype(np.float32), dst)
        assert got.dtype == want.dtype == np.float32 and got.shape == (dst, dst, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", RESIZES + [((320, 280), (256, 300)), ((41, 33), (17, 64))])
def test_resize_mask_matches_pillow(src, dst):
    shape = src if isinstance(src, tuple) else (src, src)
    mask = _content(np.random.default_rng(sum(shape)), shape)
    got = base.resize_mask(mask, dst)
    np.testing.assert_array_equal(got, jbase.resize_mask(mask, dst))
    assert got.dtype == np.uint8


def test_nearest_index_is_pillow_repeated_addition():
    """At 512 -> 384 the accumulated source coordinate truncates below
    floor((x + 0.5) * in / out) for some x; the port follows Pillow."""
    formula = np.floor((np.arange(384) + 0.5) * 512 / 384).astype(np.int64)
    got = base._nearest_index(512, 384)
    assert (got != formula).any()
    mask = np.arange(512, dtype=np.uint8)[None, :].repeat(2, 0)
    np.testing.assert_array_equal(base.resize_mask(mask, (2, 384))[0], jbase.resize_mask(mask, (2, 384))[0])


def test_to_uint8_saturate():
    arr = np.array([[-5, 0, 255, 256, 4000]], np.int32)
    np.testing.assert_array_equal(base.to_uint8_saturate(arr), jbase.to_uint8_saturate(arr))
