"""The SOD mask path as the port ran it frame by frame before it ran
batches on the device (``dynamicfuion_python_tpu_torch/apps/sod.py``): per
frame at batch 1, the numpy resize to the network's input, the per-image
maximum and the ImageNet normalization on the host, U²-Net's forward, the
host's min-max normalization, quantization and resize back to the frame's
size. The bicubic resize, Pillow's BICUBIC on 8-bit images bit for bit, is
copied in from the port's ``data/images.py`` beside its bilinear sibling
in ``portbench/reference/data/images.py``.

The forward runs in FP32 with TF32 off for cuBLAS and cuDNN, as the
configurations state; ``tf32=True`` computes it one precision lower, for
the control of ``correct``.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406])
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225])
_PRECISION_BITS = 32 - 8 - 2


def _cubic(x: float) -> float:
    """Pillow's bicubic filter: Keys' cubic with a = -0.5, support 2."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coefficients(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Per output pixel: the first source index and the fixed-point weights
    of its taps, zero-padded to a common length ([out], [out, taps])."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
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
            k.append(_cubic((x + xmin - center + 0.5) * ss))
        ww = sum(k)
        if ww != 0.0:
            k = [v / ww for v in k]
        starts[xx] = xmin
        weights[xx, :xmax] = [
            int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0 else int(0.5 + v * (1 << _PRECISION_BITS)) for v in k
        ]
    return starts, weights


def _resample_axis0(image: np.ndarray, out_size: int) -> np.ndarray:
    starts, weights = _coefficients(image.shape[0], out_size)
    taps = np.minimum(starts[:, None] + np.arange(weights.shape[1]), image.shape[0] - 1)
    gathered = image[taps].astype(np.int64)  # [out, taps, ...]
    wts = weights.reshape(weights.shape + (1,) * (image.ndim - 1))
    acc = (1 << (_PRECISION_BITS - 1)) + np.sum(gathered * wts, axis=1)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(image: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """uint8 ``image`` [H, W] or [H, W, C] resized to ``size_hw`` by
    Pillow's bicubic resampling (antialiased when reducing)."""
    if image.dtype != np.uint8:
        raise ValueError(f"resize_bicubic takes uint8 images, got {image.dtype}")
    h, w = size_hw
    out = image
    if w != image.shape[1]:
        out = np.moveaxis(_resample_axis0(np.moveaxis(out, 1, 0), w), 0, 1)
    if h != image.shape[0]:
        out = _resample_axis0(out, h)
    return np.ascontiguousarray(out)


def preprocess(rgb: np.ndarray, resize_to: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, 3] -> the network's f32 [1, 3, h, w] input: resized,
    scaled by the per-image maximum, ImageNet-normalized (in f64, then
    f32)."""
    arr = resize_bicubic(rgb, resize_to).astype(np.float32)
    arr = arr / max(float(arr.max()), 1e-6)
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(arr.astype(np.float32).transpose(2, 0, 1)[None])


def mask_from_probability(prob: np.ndarray, frame_hw: tuple[int, int], threshold: float | None) -> np.ndarray:
    """Fused probability f32[h, w] -> uint8 mask at the frame's size."""
    prob = (prob - prob.min()) / max(prob.max() - prob.min(), 1e-8)
    if threshold is not None:
        prob = (prob >= threshold).astype(np.float32)
    return resize_bicubic((prob * 255).astype(np.uint8), frame_hw)


@contextlib.contextmanager
def _precision(tf32: bool):
    previous = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = previous


def frame_outputs(model: torch.nn.Module, rgb: np.ndarray, resize_to: tuple[int, int],
                  tf32: bool = False) -> tuple[np.ndarray, list[np.ndarray]]:
    """One frame through ``model`` (eval mode, on its device) at batch 1:
    the network's input f32 [3, h, w] and its seven outputs (fused, side1 ..
    side6), each f32 [h, w], on the host."""
    x = preprocess(rgb, resize_to)
    device = next(model.parameters()).device
    with torch.no_grad(), _precision(tf32):
        outputs = model(torch.as_tensor(x, device=device))
    return x[0], [o[0, 0].cpu().numpy() for o in outputs]
