"""The port's PNG codec (``refactored_orb_slam2_tpu_torch/io/png.py``) on the
CPU, held to cv2 (OpenCV 5.0 on libpng) as the JAX package's readers use it.

- cv2-written grey8, grey16, RGB8 and RGBA8 files: ``read_png`` equal to
  ``cv2.imread(IMREAD_UNCHANGED)`` (colour in RGB order, alpha dropped),
  ``imread_gray`` equal to ``cv2.imread(IMREAD_GRAYSCALE)`` (libpng's
  fixed-point RGB to grey, 16-bit samples to their high byte).
- Files this test writes itself, with each of the five row filters on
  alternate rows (row r takes filter r % 5, or one filter on every row) and
  the image data split over three IDAT chunks: equal to the pixels, and cv2
  reads the same pixels from them.
- ``write_png``'s files read back equal through both cv2 and the port.
- Every unsupported kind raises ``ValueError`` naming what it met.
"""

import struct
import zlib

import numpy as np
import pytest

from refactored_orb_slam2_tpu_torch.io import png

cv2 = pytest.importorskip("cv2")


def _chunk(kind: bytes, payload: bytes, crc=None) -> bytes:
    crc = zlib.crc32(kind + payload) if crc is None else crc
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def _filtered(pix: np.ndarray, bpp: int, ftypes: np.ndarray) -> bytes:
    """PNG rows of the (h, n) byte image ``pix``, row r filtered with
    ``ftypes[r]`` (the encoder needs no recurrence: every predictor reads
    the raw pixels)."""
    p = pix.astype(np.int32)
    h, n = p.shape
    a = np.zeros_like(p)
    a[:, bpp:] = p[:, :-bpp]                      # left
    b = np.zeros_like(p)
    b[1:] = p[:-1]                                # up
    c = np.zeros_like(p)
    c[1:, bpp:] = p[:-1, :-bpp]                   # up-left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(p), a, b, (a + b) // 2, paeth])
    pred = preds[ftypes[:, None], np.arange(h)[:, None], np.arange(n)[None, :]]
    rows = np.concatenate([ftypes[:, None], (p - pred) & 255], axis=1)
    return rows.astype(np.uint8).tobytes()


def _write(path, pix, depth, colour, ftypes, n_idat=3, interlace=0):
    """A PNG of ``pix`` ((h, w) grey or (h, w, c)) with the given filters,
    its zlib stream cut into ``n_idat`` IDAT chunks."""
    h, w = pix.shape[:2]
    body = pix.astype(">u2") if depth == 16 else pix.astype(np.uint8)
    raw = np.ascontiguousarray(body).view(np.uint8).reshape(h, -1)
    bpp = raw.shape[1] // w
    data = zlib.compress(_filtered(raw, bpp, np.asarray(ftypes, np.int64)))
    cuts = np.linspace(0, len(data), n_idat + 1).astype(int)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + _chunk(b"IHDR", ihdr)
                + b"".join(_chunk(b"IDAT", data[i:j]) for i, j in zip(cuts[:-1], cuts[1:]))
                + _chunk(b"IEND", b""))


KINDS = {   # name -> (cv2 array maker, dtype)
    "grey8": lambda rng: rng.integers(0, 256, (37, 53), dtype=np.uint8),
    "grey16": lambda rng: rng.integers(0, 65536, (37, 53), dtype=np.uint16),
    "rgb8": lambda rng: rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
    "rgba8": lambda rng: rng.integers(0, 256, (37, 53, 4), dtype=np.uint8),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_reader_equals_cv2_on_cv2_files(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    bgr = KINDS[kind](rng)
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, bgr)
    got = png.read_png(path)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if ref.ndim == 3:                       # cv2: BGR(A); the port: RGB, alpha dropped
        ref = ref[..., 2::-1]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    grey = png.imread_gray(path)
    ref_grey = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert grey.dtype == ref_grey.dtype == np.uint8
    np.testing.assert_array_equal(grey, ref_grey)


def test_rgb_to_grey_equals_cv2_on_every_channel_value(tmp_path):
    """All 256 values of each channel against the two others drawn at
    random: libpng's weights (9797, 19234, 3737) >> 15, truncated."""
    rng = np.random.default_rng(5)
    v = np.arange(256, dtype=np.uint8)
    bgr = rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    for ch in range(3):
        bgr[ch, :, :, ch] = v[None, :]
    path = str(tmp_path / "rgb.png")
    assert cv2.imwrite(path, bgr.reshape(768, 256, 3))
    np.testing.assert_array_equal(png.imread_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("depth,colour,channels", [(8, 0, 1), (16, 0, 1), (8, 2, 3),
                                                   (16, 2, 3), (8, 6, 4), (16, 6, 4)])
@pytest.mark.parametrize("filters", ["alternate", "none", "sub", "up", "average", "paeth"])
def test_every_filter_and_split_idat(tmp_path, depth, colour, channels, filters):
    rng = np.random.default_rng(depth + colour)
    h, w = 23, 31
    shape = (h, w) if channels == 1 else (h, w, channels)
    pix = rng.integers(0, 1 << depth, shape).astype(np.uint16 if depth == 16 else np.uint8)
    pix[5:9] = pix[4:5]                     # flat stretches: ties in the Paeth predictor
    if filters == "alternate":
        ftypes = np.arange(h) % 5
    else:
        ftypes = np.full(h, ["none", "sub", "up", "average", "paeth"].index(filters))
    path = str(tmp_path / "f.png")
    _write(path, pix, depth, colour, ftypes)
    want = pix if channels == 1 else pix[..., :3]
    got = png.read_png(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)      # the test's encoder is right
    np.testing.assert_array_equal(ref if channels == 1 else ref[..., 2::-1], want)
    if depth == 8:
        np.testing.assert_array_equal(png.imread_gray(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("shape", [(1, 1), (1, 40), (40, 1), (376, 1241)])
def test_wavefront_edges(tmp_path, shape):
    """One row, one column, and a KITTI frame under the anti-diagonal
    decoder (Average and Paeth rows, so every row takes it)."""
    rng = np.random.default_rng(shape[0])
    pix = np.clip(rng.normal(120, 40, shape), 0, 255).astype(np.uint8)
    path = str(tmp_path / "e.png")
    _write(path, pix, 8, 0, np.arange(shape[0]) % 2 + 3, n_idat=1)
    np.testing.assert_array_equal(png.read_png(path), pix)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_writer_reads_back_through_cv2_and_the_port(tmp_path, dtype):
    rng = np.random.default_rng(9)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (41, 67)).astype(dtype)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    for got in (png.read_png(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, img)
    with open(path, "rb") as f:                 # filter 0 on every row
        data = f.read()
    rows = np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4:-16]), np.uint8)
    assert not rows.reshape(41, -1)[:, 0].any()


def _ihdr_file(path, depth=8, colour=0, interlace=0, body=b"\x00\x00"):
    ihdr = struct.pack(">IIBBBBB", 1, 1, depth, colour, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("case,needle", [
    ("interlaced", "interlace"), ("palette", "palette"), ("grey+alpha", "alpha"),
    ("depth 1", "bit depth 1"), ("depth 2", "bit depth 2"), ("depth 4", "bit depth 4"),
    ("bad crc", "CRC"), ("not png", "not a PNG"), ("filter 5", "row filter 5"),
    ("short data", "bytes"), ("truncated", "truncated")])
def test_unsupported_kinds_raise(tmp_path, case, needle):
    path = str(tmp_path / "bad.png")
    if case == "interlaced":
        _ihdr_file(path, interlace=1)
    elif case == "palette":
        _ihdr_file(path, colour=3)
    elif case == "grey+alpha":
        _ihdr_file(path, colour=4)
    elif case.startswith("depth"):
        _ihdr_file(path, depth=int(case.split()[1]))
    elif case == "filter 5":
        _ihdr_file(path, body=b"\x05\x00")
    elif case == "short data":
        _ihdr_file(path, body=b"\x00")
    elif case == "bad crc":
        ihdr = struct.pack(">IIBBBBB", 1, 1, 8, 0, 0, 0, 0)
        with open(path, "wb") as f:
            f.write(png.SIGNATURE + _chunk(b"IHDR", ihdr, crc=0))
    elif case == "not png":
        with open(path, "wb") as f:
            f.write(b"GIF89a" + bytes(20))
    else:
        png.write_png(path, np.zeros((4, 4), np.uint8))
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:-20])
    with pytest.raises(ValueError, match=needle):
        png.read_png(path)


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 3), np.uint8), np.zeros((4, 4), np.float32),
                                 np.zeros((0, 4), np.uint8)])
def test_writer_refuses_what_it_cannot_write(tmp_path, bad):
    with pytest.raises(ValueError, match="2-D uint8 or uint16"):
        png.write_png(str(tmp_path / "x.png"), bad)
