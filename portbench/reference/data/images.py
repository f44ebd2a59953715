"""Image files and resizes without Pillow.

PNG frames (8-bit colour, 16-bit depth, any row filter) are read by
:func:`read_png` and written by :func:`write_png` with ``zlib`` alone (the
port's ``utils/telemetry.py`` PNG code); other formats are not read. The
resizes give Pillow's results: :func:`resize_nearest` is
``Image.resize(..., NEAREST)`` bit for bit (8-, 16-bit, 32-bit and float
images), and :func:`resize_bilinear` is ``Image.resize(..., BILINEAR)`` on
8-bit images (a triangle filter widened by the reduction factor,
fixed-point weights, the horizontal pass first, each pass clipped to
0..255).
"""

from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def write_png(path: str | Path, image) -> None:
    """Write uint8 [H, W, 3] (RGB), uint8 [H, W] or uint16 [H, W] (grey) as a
    PNG: one IDAT chunk, every row with filter 0, default zlib level."""
    a = np.asarray(image)
    if a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        bit_depth, color_type = 8, 2
    elif a.dtype in (np.uint8, np.uint16) and a.ndim == 2:
        bit_depth, color_type = 8 * a.dtype.itemsize, 0
    else:
        raise ValueError(f"write_png takes uint8 [H, W, 3] or uint8 / uint16 [H, W], got {a.dtype}{list(a.shape)}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a.astype(a.dtype.newbyteorder(">"))).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", zlib.crc32(tag + payload))

    header = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # grey, RGB, grey + alpha, RGBA


def _unfilter(filtered: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth) of
    the bytes ``filtered`` uint8[H, stride]; ``bpp`` bytes per pixel.

    A byte depends on its left, upper and upper-left neighbors, so the
    bytes of one anti-diagonal (row + pixel column constant) are
    independent: the loop runs over the H + W - 1 anti-diagonals, each step
    vectorized over rows and the bytes of a pixel."""
    h, stride = filtered.shape
    if not filters.any():
        return filtered
    if filters.max() > 4:
        raise ValueError(f"PNG row filter {int(filters.max())} does not exist")
    wpix = stride // bpp
    f = filtered.reshape(h, wpix, bpp).astype(np.int32)
    out = np.zeros((h + 1, wpix + 1, bpp), np.int32)  # a zero row above and a zero column left
    rows_all = np.arange(h)
    for diag in range(h + wpix - 1):
        r = rows_all[max(0, diag - wpix + 1) : min(h, diag + 1)]
        p = diag - r
        a = out[r + 1, p]  # left
        b = out[r, p + 1]  # up
        c = out[r, p]  # upper left
        kind = filters[r][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, p + 1] = (f[r, p] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, stride)


def read_png(path: str | Path) -> np.ndarray:
    """Read a non-interlaced 8- or 16-bit PNG: grey -> [H, W], RGB ->
    [H, W, 3], grey + alpha -> [H, W, 2], RGBA -> [H, W, 4], as uint8 or
    uint16; every row filter. Raises on palette images, bit depths below 8
    and interlacing."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag, payload = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])[0] != zlib.crc32(tag + payload):
            raise ValueError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + length
    w, h, bit_depth, color_type, _, _, interlace = header
    if color_type not in _PNG_CHANNELS or bit_depth not in (8, 16) or interlace:
        raise ValueError(
            f"{path}: color type {color_type}, bit depth {bit_depth}, interlace {interlace} is not read here "
            "(8- or 16-bit grey, grey + alpha, RGB or RGBA, not interlaced)"
        )
    channels = _PNG_CHANNELS[color_type]
    dtype = np.dtype(">u2") if bit_depth == 16 else np.dtype(np.uint8)
    bpp = channels * dtype.itemsize
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[: h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    raw = _unfilter(rows[:, 1:], rows[:, 0], bpp)
    image = np.ascontiguousarray(raw).view(dtype).astype(dtype.newbyteorder("="))
    return image.reshape(h, w, channels) if channels > 1 else image.reshape(h, w)


def read_image(path: str | Path) -> np.ndarray:
    """The pixels of a PNG file."""
    return read_png(path)


def load_color(path: str | Path) -> np.ndarray:
    """uint8 [H, W, 3] RGB: grey is repeated, alpha dropped (Pillow's
    ``convert("RGB")``)."""
    img = read_image(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a colour frame must be 8-bit, got {img.dtype}")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] in (2, 4):  # grey + alpha, RGBA
        img = img[..., :-1]
    return np.ascontiguousarray(np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img)


def load_depth(path: str | Path) -> np.ndarray:
    """uint16 [H, W] depth (millimetres in DeepDeform's layout)."""
    img = read_image(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: a depth frame must be single-channel, got shape {img.shape}")
    return img.astype(np.uint16)


def _nearest_index(in_size: int, out_size: int, running_sum: bool) -> np.ndarray:
    """Pillow's nearest-neighbour source index of each output column, the
    source coordinate of column i being (i + 1/2) steps, truncated. Pillow's
    8-bit, 32-bit and float images add the step column by column (a running
    sum); its 16-bit images multiply. The two round apart now and then."""
    scale = in_size / out_size
    out = np.empty(out_size, np.int64)
    x = scale * 0.5
    for i in range(out_size):
        out[i] = min(int(x if running_sum else (i + 0.5) * scale), in_size - 1)
        x += scale
    return out


def resize_nearest(image: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """``image`` [H, W, ...] resized to ``size_hw`` by nearest neighbour, as
    Pillow resizes an image of its dtype (uint16: Pillow's 16-bit mode)."""
    h, w = size_hw
    running_sum = image.dtype != np.uint16
    rows = _nearest_index(image.shape[0], h, running_sum)
    cols = _nearest_index(image.shape[1], w, running_sum)
    return image[rows][:, cols]


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


_FILTERS = {"bilinear": (_triangle, 1.0)}


def _coefficients(in_size: int, out_size: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """Per output pixel: the first source index and the fixed-point weights
    of its taps, zero-padded to a common length ([out], [out, taps])."""
    filt, filter_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = []
        for x in range(xmax):
            k.append(filt((x + xmin - center + 0.5) * ss))
        ww = sum(k)
        if ww != 0.0:
            k = [v / ww for v in k]
        starts[xx] = xmin
        weights[xx, :xmax] = [
            int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0 else int(0.5 + v * (1 << _PRECISION_BITS)) for v in k
        ]
    return starts, weights


def _resample_axis0(image: np.ndarray, out_size: int, kind: str) -> np.ndarray:
    starts, weights = _coefficients(image.shape[0], out_size, kind)
    taps = np.minimum(starts[:, None] + np.arange(weights.shape[1]), image.shape[0] - 1)
    gathered = image[taps].astype(np.int64)  # [out, taps, ...]
    wts = weights.reshape(weights.shape + (1,) * (image.ndim - 1))
    acc = (1 << (_PRECISION_BITS - 1)) + np.sum(gathered * wts, axis=1)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_8bit(image: np.ndarray, size_hw: tuple[int, int], kind: str) -> np.ndarray:
    if image.dtype != np.uint8:
        raise ValueError(f"resize_{kind} takes uint8 images, got {image.dtype}")
    h, w = size_hw
    out = image
    if w != image.shape[1]:
        out = np.moveaxis(_resample_axis0(np.moveaxis(out, 1, 0), w, kind), 0, 1)
    if h != image.shape[0]:
        out = _resample_axis0(out, h, kind)
    return np.ascontiguousarray(out)


def resize_bilinear(image: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """uint8 ``image`` [H, W] or [H, W, C] resized to ``size_hw`` by
    Pillow's bilinear resampling (antialiased when reducing)."""
    return _resize_8bit(image, size_hw, "bilinear")
