"""PNG codec on ``zlib`` and numpy: the port's image reader and writer.

The dataset readers (``io/datasets.py``) and the fixture writer
(``scripts/make_fixture.py``) read and write PNG files through this module,
so no image library is needed on any path the card runs.

Reading (``read_png``): non-interlaced PNGs of colour type 0 (grey), 2 (RGB)
and 6 (RGBA, the alpha dropped), 8 or 16 bits per sample, all five row
filters, the image data split over any number of IDAT chunks; every chunk's
CRC is checked. Anything else (interlacing, a palette, grey with alpha,
fewer than 8 bits per sample, a bad CRC or a truncated stream) raises
``ValueError`` naming what it met.

Rows filtered with None, Sub or Up decode one row at a time, each row one
vector operation (Sub is a wrapping cumulative sum along the row). Average
and Paeth depend on the decoded byte to the left, so an image holding
either decodes along anti-diagonals instead: pixel (r, x) needs (r, x-1),
(r-1, x) and (r-1, x-1), which all lie on the two diagonals before its own,
so every row advances by one pixel per vector step (H + W - 1 steps for an
H x W image).

``imread_gray`` gives what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives
(OpenCV 5.0 on libpng): 16-bit samples keep their high byte, and RGB becomes
grey by libpng's ``png_do_rgb_to_gray`` with the fixed-point weights that
``png_set_rgb_to_gray(png, 1, 0.299, 0.587)`` sets, truncated:
``(9797 R + 19234 G + 3737 B) >> 15``.

Writing (``write_png``): 2-D uint8 or uint16 arrays as grey PNGs, filter 0
(None) on every row, one IDAT at zlib level ``ZLIB_LEVEL``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
ZLIB_LEVEL = 3
# libpng's rgb_to_gray weights for (0.299, 0.587): int(w * 32768) for red and
# green, blue the rest of 32768
GRAY_WEIGHTS = (9797, 19234, 3737)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR_NAMES = {3: "a palette (colour type 3)", 4: "grey with alpha (colour type 4)"}


def _chunks(data: bytes, path):
    """(type, payload) of every chunk, each CRC checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (signature {data[:8]!r})")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated before IEND")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: CRC mismatch in the {kind.decode('latin-1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def _header(ihdr: bytes, path):
    w, h, depth, colour, comp, filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG (interlace method {interlace}) is not supported")
    if colour in _COLOUR_NAMES:
        raise ValueError(f"{path}: {_COLOUR_NAMES[colour]} is not supported")
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: unknown colour type {colour}")
    if depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {depth} is not supported (8 or 16 only)")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: compression method {comp} / filter method {filt}")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: empty image {w}x{h}")
    return w, h, depth, colour


def _unfilter_rows(ftype, raw, bpp):
    """Rows filtered with None (0), Sub (1) or Up (2) only: one row at a time."""
    h, n = raw.shape
    out = np.empty_like(raw)
    prior = np.zeros(n, np.uint8)
    for r in range(h):
        f = ftype[r]
        if f == 0:
            out[r] = raw[r]
        elif f == 1:
            out[r] = raw[r].reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).reshape(-1)
        else:
            np.add(raw[r], prior, out=out[r])
        prior = out[r]
    return out


def _unfilter_wavefront(ftype, raw, w, bpp):
    """Every filter, Average and Paeth included, along anti-diagonals.

    Pixel (r, x) lives at ``dec[r + x + 2, r + 1]``: the two leading
    diagonals and the leading row stay zero, so the left neighbour of x = 0
    and the row above row 0 read as 0, as the PNG specification has it.
    """
    h = raw.shape[0]
    nd = h + w - 1
    src = raw.reshape(h, w, bpp).astype(np.int16)
    # skew: pixel (r, x) to diagonal r + x of row r
    pad = np.zeros((h, w + h, bpp), np.int16)
    pad[:, :w] = src
    skew = pad.reshape(h * (w + h), bpp)[:h * nd].reshape(h, nd, bpp)
    diag = np.ascontiguousarray(skew.transpose(1, 0, 2))          # (nd, h, bpp)
    dec = np.zeros((nd + 2, h + 1, bpp), np.int16)
    # None, Sub, Up and Average predict (ka * left + kb * up) >> 1; Paeth rows
    # take the Paeth predictor instead
    ka = np.array([0, 2, 0, 1, 0], np.int16)[ftype][:, None]
    kb = np.array([0, 0, 2, 1, 0], np.int16)[ftype][:, None]
    is_paeth = (ftype == 4)[:, None]
    any_paeth = bool(is_paeth.any())
    for d in range(nd):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1
        a = dec[d + 1, lo + 1:hi + 1]        # left
        b = dec[d + 1, lo:hi]                # up
        pred = (a * ka[lo:hi] + b * kb[lo:hi]) >> 1
        if any_paeth:
            c = dec[d, lo:hi]                # up-left
            # p = a + b - c: |p - a| = |b - c|, |p - b| = |a - c|, |p - c| their sum's
            sa, sb = b - c, a - c
            pa, pb, pc = np.abs(sa), np.abs(sb), np.abs(sa + sb)
            paeth = np.where(pa <= np.minimum(pb, pc), a, np.where(pb <= pc, b, c))
            pred = np.where(is_paeth[lo:hi], paeth, pred)
        np.bitwise_and(diag[d, lo:hi] + pred, 255, out=dec[d + 2, lo + 1:hi + 1])
    # unskew: row r of the transpose holds pixel (r, x) at r + x, so in its
    # flat layout at r * (nd + 1) + x
    flat = dec[2:, 1:].transpose(1, 0, 2).astype(np.uint8).reshape(h * nd, bpp)
    flat = np.concatenate([flat, np.zeros((h, bpp), np.uint8)])
    return flat.reshape(h, nd + 1, bpp)[:, :w].reshape(h, w * bpp)


def read_png(path) -> np.ndarray:
    """Decode a PNG file: (H, W) for grey, (H, W, 3) RGB for colour types 2
    and 6 (alpha dropped); uint8 or uint16 (native byte order)."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = _header(body, path)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: no {'IHDR' if header is None else 'IDAT'} chunk")
    w, h, depth, colour = header
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    stride = w * bpp + 1
    try:
        stream = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    if len(stream) != h * stride:
        raise ValueError(f"{path}: image data holds {len(stream)} bytes, "
                         f"{h} rows of {stride} expected")
    rows = np.frombuffer(stream, np.uint8).reshape(h, stride)
    ftype, raw = rows[:, 0], rows[:, 1:]
    if ftype.max() > 4:
        raise ValueError(f"{path}: unknown row filter {int(ftype.max())}")
    if (ftype >= 3).any():
        pix = _unfilter_wavefront(ftype, raw, w, bpp)
    else:
        pix = _unfilter_rows(ftype, raw, bpp)
    if depth == 16:
        img = pix.view(">u2").astype(np.uint16)
    else:
        img = pix
    img = img.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img[..., :3]


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB to (H, W) uint8 grey by libpng's fixed-point
    weights, truncated (see the module docstring)."""
    wr, wg, wb = GRAY_WEIGHTS
    x = rgb.astype(np.uint32)
    return ((wr * x[..., 0] + wg * x[..., 1] + wb * x[..., 2]) >> 15).astype(np.uint8)


def imread_gray(path) -> np.ndarray:
    """(H, W) uint8 grey, as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    return rgb_to_gray(img) if img.ndim == 3 else img


def write_png(path, array: np.ndarray) -> None:
    """Write a 2-D uint8 or uint16 array as a grey PNG (filter 0 on every
    row, zlib level ``ZLIB_LEVEL``)."""
    a = np.asarray(array)
    if a.ndim != 2 or a.dtype not in (np.uint8, np.uint16) or a.size == 0:
        raise ValueError(f"write_png takes a non-empty 2-D uint8 or uint16 array, "
                         f"got {a.dtype} {a.shape}")
    h, w = a.shape
    depth = 8 * a.dtype.itemsize
    body = a.astype(">u2") if depth == 16 else a
    rows = np.zeros((h, w * a.dtype.itemsize + 1), np.uint8)
    rows[:, 1:] = np.ascontiguousarray(body).view(np.uint8).reshape(h, -1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(rows.tobytes(), ZLIB_LEVEL))
                 + chunk(b"IEND", b""))
