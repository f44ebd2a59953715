"""Image files and resizes without Pillow.

PNG frames (8-bit colour, 16-bit depth, any row filter) are read by
``utils/telemetry.py::read_png``; a JPEG colour frame needs Pillow, imported
only when one is read. The three resizes give Pillow's results:
:func:`resize_nearest` is ``Image.resize(..., NEAREST)`` bit for bit (8-,
16-bit, 32-bit and float images), and :func:`resize_bilinear` /
:func:`resize_bicubic` are ``Image.resize(..., BILINEAR / BICUBIC)`` on
8-bit images (a triangle / Keys cubic filter widened by the reduction
factor, fixed-point weights, the horizontal pass first, each pass clipped
to 0..255). :func:`resize_images` is the same 8-bit resampler on a batch
of uint8 tensors on any device, bit-equal to the numpy form.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.utils import trace
from dynamicfuion_python_tpu_torch.utils.telemetry import read_png

_PRECISION_BITS = 32 - 8 - 2


def _read_with_pillow(path: Path) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            f"{path}: reading a {path.suffix} image needs Pillow, which is not installed; "
            "PNG frames are read without it"
        ) from exc
    with Image.open(path) as img:
        if img.mode in ("RGB", "L", "I;16", "I"):
            return np.asarray(img)
        return np.asarray(img.convert("RGB"))


def read_image(path: str | Path) -> np.ndarray:
    """The pixels of a PNG (any file that starts with the PNG signature), or
    of another format through Pillow."""
    path = Path(path)
    with open(path, "rb") as f:
        is_png = f.read(8) == b"\x89PNG\r\n\x1a\n"
    return read_png(path) if is_png else _read_with_pillow(path)


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


def _cubic(x: float) -> float:
    """Pillow's bicubic filter: Keys' cubic with a = -0.5, support 2."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_FILTERS = {"bilinear": (_triangle, 1.0), "bicubic": (_cubic, 2.0)}


@functools.lru_cache(maxsize=64)
def _coefficients(in_size: int, out_size: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """Per output pixel: the first source index and the fixed-point weights
    of its taps, zero-padded to a common length ([out], [out, taps]).
    Cached by (in, out, kind): the arrays are shared, so read-only."""
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
    starts.flags.writeable = weights.flags.writeable = False
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


def resize_bicubic(image: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """uint8 ``image`` [H, W] or [H, W, C] resized to ``size_hw`` by
    Pillow's bicubic resampling (antialiased when reducing), the default of
    ``Image.resize`` for RGB and L images."""
    return _resize_8bit(image, size_hw, "bicubic")


@functools.lru_cache(maxsize=64)
def _weight_matrix(in_size: int, out_size: int, kind: str, device: torch.device) -> torch.Tensor:
    """The fixed-point taps of :func:`_coefficients` as a dense f64 [in,
    out] matrix on ``device``, uploaded once per sizes and device."""
    starts, weights = _coefficients(in_size, out_size, kind)
    dense = np.zeros((in_size, out_size), np.float64)
    rows = starts[:, None] + np.arange(weights.shape[1])
    taps = weights != 0  # a zero tap may lie past the image's edge
    dense[rows[taps], np.nonzero(taps)[0]] = weights[taps]
    return trace.upload(dense, device, "resize.weights")


def _resample_last(images: torch.Tensor, out_size: int, kind: str) -> torch.Tensor:
    """One pass over the last axis of f64 ``images`` that hold 0..255, as
    :func:`_resample_axis0` computes it. Each product of a pixel and a
    fixed-point weight is an integer under 2**31 and their sums stay under
    2**53, so the f64 matrix product is exact in any order of summation."""
    acc = images @ _weight_matrix(images.shape[-1], out_size, kind, images.device)
    return torch.floor((acc + (1 << (_PRECISION_BITS - 1))) * 2.0**-_PRECISION_BITS).clamp_(0, 255)


def resize_images(images: torch.Tensor, size_hw: tuple[int, int], kind: str = "bicubic") -> torch.Tensor:
    """uint8 ``images`` [B, H, W, C] resized to ``size_hw`` by Pillow's
    ``kind`` ("bicubic" or "bilinear") resampling, on their device:
    :func:`resize_bicubic` / :func:`resize_bilinear` of each image, bit for
    bit (the horizontal pass first, each pass clipped to 0..255)."""
    if images.dtype != torch.uint8 or images.ndim != 4:
        raise ValueError(f"resize_images takes uint8 [B, H, W, C] images, got {images.dtype} {tuple(images.shape)}")
    h, w = size_hw
    out = images.permute(0, 3, 1, 2).to(torch.float64)  # [B, C, H, W]
    if w != images.shape[2]:
        out = _resample_last(out, w, kind)
    if h != images.shape[1]:
        out = _resample_last(out.transpose(2, 3), h, kind).transpose(2, 3)
    return out.to(torch.uint8).permute(0, 2, 3, 1).contiguous()
