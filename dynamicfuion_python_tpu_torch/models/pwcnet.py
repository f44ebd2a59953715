"""PWC-Net optical flow (port of ``dynamicfuion_python_tpu/models/pwcnet.py``):
a 6-level feature pyramid (16/32/64/96/128/196 channels), per-level decoders
(cost volume of the first image's features against the second's, backward
warped by the upsampled coarser flow, then densely connected 128/128/96/64/32
convolutions), and a dilated-convolution refiner of the finest flow. Returns
(flow2..flow6, features2), flows at 1/4..1/64 resolution; features2 has 565
channels.

The modules run NCHW inside and take and return NHWC, as the JAX package's
do. Submodule names are the reference checkpoint's (``moduleExtractor``,
``moduleTwo``..``moduleSix`` with ``moduleUpflow`` / ``moduleUpfeat`` /
``moduleOne``..``moduleSix``, ``moduleRefiner.moduleMain``), so its
``state_dict`` loads with ``load_state_dict`` alone.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynamicfuion_python_tpu_torch.ops.correlation import correlation
from dynamicfuion_python_tpu_torch.ops.image_warp import backward_warp
from dynamicfuion_python_tpu_torch.ops.segment_sum import fp32_matmuls

_WORDS = ("One", "Two", "Thr", "Fou", "Fiv", "Six")
EXTRACTOR_WIDTHS = (16, 32, 64, 96, 128, 196)
DECODER_WIDTHS = (128, 128, 96, 64, 32)
REFINER_WIDTHS = (128, 128, 128, 96, 64, 32)
REFINER_DILATIONS = (1, 2, 4, 8, 16, 1)
# per-level flow scales applied before warping (the reference's table)
_SCALES = {3: 5.0, 4: 2.5, 5: 1.25, 6: 0.625}
COST_CHANNELS = 81


def _leaky(x):
    return F.leaky_relu(x, negative_slope=0.1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class Extractor(nn.Module):
    """The feature pyramid: per level a stride-2 conv (padding 1 on each
    side, as the reference's torch convs pad) and two 3x3 convs, each
    followed by a leaky ReLU."""

    def __init__(self):
        super().__init__()
        c_in = 3
        for word, c in zip(_WORDS, EXTRACTOR_WIDTHS):
            setattr(self, f"module{word}", nn.Sequential(
                nn.Conv2d(c_in, c, 3, stride=2, padding=1), nn.LeakyReLU(0.1),
                nn.Conv2d(c, c, 3, padding=1), nn.LeakyReLU(0.1),
                nn.Conv2d(c, c, 3, padding=1), nn.LeakyReLU(0.1),
            ))
            c_in = c

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """NCHW image -> the 6 NCHW levels, finest first."""
        pyramid = []
        for word in _WORDS:
            x = getattr(self, f"module{word}")(x)
            pyramid.append(x)
        return pyramid


def _decoder_in_channels(level: int) -> int:
    if level == 6:
        return COST_CHANNELS
    return COST_CHANNELS + EXTRACTOR_WIDTHS[level - 1] + 2 + 2


class PhaseConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d(in, out, 4, stride=2, padding=1)``, PWC-Net's and
    MaskNet's 2x upsampling. On the CPU it is that module's forward. On the
    card it is four ordinary 2x2 convolutions, one per output phase (output
    row 2m + r reads input rows m - 1, m with taps 3, 1 when r = 0 and m,
    m + 1 with taps 2, 0 when r = 1; columns alike), interleaved: cuDNN runs
    a transposed convolution as its backward-data pass, whose default
    algorithm differed from run to run on an H100 and whose deterministic
    one took ~5 ms a call at PWC-Net's shapes, where a forward convolution
    repeats bit for bit."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return super().forward(x)
        return upsample_by_phases(x, self.weight, self.bias)


def upsample_by_phases(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """``F.conv_transpose2d(x, weight, bias, stride=2, padding=1)`` for a
    4x4 ``weight`` [Cin, Cout, 4, 4] as four 2x2 ``conv2d`` over the phases
    of the output -> [B, Cout, 2H, 2W]."""
    b, _, h, w = x.shape
    taps = weight.transpose(0, 1).flip(-2, -1)  # [Cout, Cin, 4, 4]: taps 3, 2, 1, 0
    rows = []
    for ry in (0, 1):
        cols = [F.conv2d(F.pad(x, (1 - rx, rx, 1 - ry, ry)), taps[:, :, ry::2, rx::2], bias) for rx in (0, 1)]
        rows.append(torch.stack(cols, dim=-1))  # [B, Cout, H, W, 2]
    return torch.stack(rows, dim=3).reshape(b, -1, 2 * h, 2 * w)


class Decoder(nn.Module):
    """One pyramid level's flow decoder with dense connections."""

    def __init__(self, level: int):
        super().__init__()
        self.level = level
        c_in = _decoder_in_channels(level)
        if level < 6:
            self.moduleUpflow = PhaseConvTranspose2d(2, 2)
            self.moduleUpfeat = PhaseConvTranspose2d(_decoder_in_channels(level + 1) + sum(DECODER_WIDTHS), 2)
        for word, c in zip(_WORDS, DECODER_WIDTHS):
            setattr(self, f"module{word}", nn.Sequential(nn.Conv2d(c_in, c, 3, padding=1), nn.LeakyReLU(0.1)))
            c_in += c
        self.moduleSix = nn.Sequential(nn.Conv2d(c_in, 2, 3, padding=1))

    def forward(self, first, second, prev):
        """NCHW features of both images at this level and the coarser level's
        (flow, features), or None at the coarsest -> (flow, features)."""
        if prev is None:
            features = _leaky(correlation(first, second))
        else:
            prev_flow, prev_features = prev
            flow_in = self.moduleUpflow(prev_flow)
            upfeat = self.moduleUpfeat(prev_features)
            scale = _SCALES[self.level + 1]
            warped = to_nchw(torch.stack([
                backward_warp(img, fl) for img, fl in zip(to_nhwc(second), to_nhwc(flow_in * scale))
            ]))
            cost = _leaky(correlation(first, warped))
            features = torch.cat([cost, first, flow_in, upfeat], dim=1)
        for word in _WORDS[:5]:
            features = torch.cat([getattr(self, f"module{word}")(features), features], dim=1)
        return self.moduleSix(features), features


class Refiner(nn.Module):
    """Dilated-conv context network refining flow2 (each conv padded by its
    dilation)."""

    def __init__(self):
        super().__init__()
        layers = []
        c_in = _decoder_in_channels(2) + sum(DECODER_WIDTHS)
        for c, d in zip(REFINER_WIDTHS, REFINER_DILATIONS):
            layers += [nn.Conv2d(c_in, c, 3, padding=d, dilation=d), nn.LeakyReLU(0.1)]
            c_in = c
        layers.append(nn.Conv2d(c_in, 2, 3, padding=1))
        self.moduleMain = nn.Sequential(*layers)

    def forward(self, features):
        return self.moduleMain(features)


class PWCNet(nn.Module):
    """The whole flow network."""

    def __init__(self):
        super().__init__()
        self.moduleExtractor = Extractor()
        for level in range(2, 7):
            setattr(self, f"module{_WORDS[level - 1]}", Decoder(level))
        self.moduleRefiner = Refiner()

    def forward_nchw(self, first: torch.Tensor, second: torch.Tensor):
        """NCHW RGB in [0, 1] -> (flow2..flow6, features2), all NCHW."""
        p1 = self.moduleExtractor(first)
        p2 = self.moduleExtractor(second)
        prev = None
        flows = {}
        for level in (6, 5, 4, 3, 2):
            flow, features = getattr(self, f"module{_WORDS[level - 1]}")(p1[level - 1], p2[level - 1], prev)
            prev = (flow, features)
            flows[level] = flow
        flows[2] = flows[2] + self.moduleRefiner(features)
        return flows[2], flows[3], flows[4], flows[5], flows[6], features

    def forward(self, first: torch.Tensor, second: torch.Tensor):
        """NHWC RGB in [0, 1] [B, H, W, 3] x 2 -> (flow2..flow6, features2),
        all NHWC."""
        return tuple(to_nhwc(x) for x in self.forward_nchw(to_nchw(first), to_nchw(second)))


@functools.lru_cache(maxsize=32)
def bilinear_weights(size_in: int, size_out: int, device: torch.device) -> torch.Tensor:
    """f32[size_out, size_in]: row ``o`` holds the weights with which
    ``F.interpolate(mode="bilinear", align_corners=False)`` blends the input
    along one axis into output ``o`` (half-pixel centres, source index
    clamped at 0, the last input repeated at the far edge), computed on
    ``device`` as PyTorch's kernels compute them, once per sizes and
    device."""
    f32 = dict(dtype=torch.float32, device=device)
    scale = torch.full((), size_in, **f32) / torch.full((), size_out, **f32)
    src = torch.clamp(scale * (torch.arange(size_out, **f32) + 0.5) - 0.5, min=0.0)
    lo = src.to(torch.int64)
    frac = src - lo
    hi = lo + (lo < size_in - 1)
    cols = torch.arange(size_in, device=device)
    return (torch.where(cols == lo[:, None], 1.0 - frac[:, None], 0.0)
            + torch.where(cols == hi[:, None], frac[:, None], 0.0))


def bilinear_resize_backward(grad: torch.Tensor, size_in: tuple[int, int]) -> torch.Tensor:
    """The gradient of a bilinear resize [B, C, h, w] -> [B, C, H, W] with
    respect to its input: the transposed resize ``Ry^T G Rx`` (``Ry``
    [H, h], ``Rx`` [W, w], :func:`bilinear_weights`), two FP32 matrix
    products (TF32 off) whose order of additions the shapes fix. The JAX
    package's ``jax.image.resize`` is the same contraction."""
    ry = bilinear_weights(size_in[0], grad.shape[-2], grad.device)
    rx = bilinear_weights(size_in[1], grad.shape[-1], grad.device)
    with fp32_matmuls():
        return torch.matmul(torch.matmul(ry.t(), grad), rx)


class _BilinearResize(torch.autograd.Function):
    """``F.interpolate(mode="bilinear", align_corners=False)`` forward. The
    backward is autograd's own on the CPU; on the card, whose own backward
    adds with float atomics, it is :func:`bilinear_resize_backward`."""

    @staticmethod
    def forward(x, size):
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.size_in = tuple(inputs[0].shape)

    @staticmethod
    def backward(ctx, grad):
        if grad.device.type == "cpu":
            size_out = list(grad.shape[-2:])
            return torch.ops.aten.upsample_bilinear2d_backward(grad, size_out, list(ctx.size_in), False), None
        if grad.device.type != "cuda":
            raise RuntimeError(f"bilinear resize: no backward for device {grad.device}")
        return bilinear_resize_backward(grad, ctx.size_in[-2:]), None


def bilinear_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """NCHW ``x`` resized to ``size`` bilinearly (half-pixel centres),
    bit-equal to ``F.interpolate``; its backward has a fixed order on the
    card."""
    return _BilinearResize.apply(x, tuple(size))


def upsample_flow_to_full(flow2: torch.Tensor, image_size: tuple[int, int]) -> torch.Tensor:
    """flow2 (1/4 resolution, NHWC) -> dense full-resolution flow in pixels:
    bilinear upsampling with half-pixel centers, times 20 (the reference's
    flow-net output convention)."""
    return to_nhwc(bilinear_resize(to_nchw(flow2), image_size)) * 20.0
