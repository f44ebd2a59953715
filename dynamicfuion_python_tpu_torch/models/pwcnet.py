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

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynamicfuion_python_tpu_torch.ops.correlation import correlation
from dynamicfuion_python_tpu_torch.ops.image_warp import backward_warp

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


def upsample_flow_to_full(flow2: torch.Tensor, image_size: tuple[int, int]) -> torch.Tensor:
    """flow2 (1/4 resolution, NHWC) -> dense full-resolution flow in pixels:
    bilinear upsampling with half-pixel centers, times 20 (the reference's
    flow-net output convention)."""
    up = F.interpolate(to_nchw(flow2), size=tuple(image_size), mode="bilinear", align_corners=False)
    return to_nhwc(up) * 20.0
