"""U²-Net salient-object-detection network (port of
``dynamicfuion_python_tpu/models/u2net.py``).

Nested U of RSU (ReSidual U-block) encoder and decoder stages with deep
side supervision, giving a per-pixel saliency probability that serves as the
foreground mask of DeepDeform-style sequences (``apps/sod.py``).

NCHW ``nn.Module``s whose parameter names are the original U-2-Net
release's (``stage1.rebnconvin.conv_s1.weight``, ``…bn_s1.running_mean``,
``side1``, ``outconv``): a published ``u2net.pth`` / ``u2netp.pth`` loads
with ``load_state_dict(strict=True)`` as it is. Down-sampling is a 2x2
max-pool with ``ceil_mode=True``; up-sampling is bilinear with
``align_corners=False`` and only ever enlarges (a deeper map is never
larger than its skip), which is what the JAX package's
``jax.image.resize(..., "bilinear")`` computes there. BatchNorm runs in
eval mode with eps 1e-5 (running statistics).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvBnRelu(nn.Module):
    """The original ``REBNCONV``: 3x3 conv (dilated, "same" padding) +
    BatchNorm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dilation, dilation=dilation)
        self.bn_s1 = nn.BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _down(x):
    return F.max_pool2d(x, 2, stride=2, ceil_mode=True)


def _up_to(x, like):
    return F.interpolate(x, size=like.shape[2:], mode="bilinear", align_corners=False)


class RSU(nn.Module):
    """ReSidual U-block of the given depth (the original RSU7 .. RSU4)."""

    def __init__(self, depth: int, in_ch: int, mid: int, out: int):
        super().__init__()
        self.depth = depth
        self.rebnconvin = ConvBnRelu(in_ch, out)
        self.rebnconv1 = ConvBnRelu(out, mid)
        for level in range(2, depth):
            setattr(self, f"rebnconv{level}", ConvBnRelu(mid, mid))
        setattr(self, f"rebnconv{depth}", ConvBnRelu(mid, mid, dilation=2))
        for level in range(depth - 1, 0, -1):
            setattr(self, f"rebnconv{level}d", ConvBnRelu(2 * mid, out if level == 1 else mid))

    def forward(self, x):
        hx_in = self.rebnconvin(x)
        encs = []
        h = hx_in
        for level in range(1, self.depth):
            h = getattr(self, f"rebnconv{level}")(h)
            encs.append(h)
            if level < self.depth - 1:
                h = _down(h)
        h = getattr(self, f"rebnconv{self.depth}")(h)
        for level in range(self.depth - 1, 0, -1):
            skip = encs[level - 1]
            if h.shape[2:] != skip.shape[2:]:
                h = _up_to(h, skip)
            h = getattr(self, f"rebnconv{level}d")(torch.cat([h, skip], dim=1))
        return h + hx_in


class RSU4F(nn.Module):
    """Dilation-only RSU (no pooling) of the deepest stages."""

    def __init__(self, in_ch: int, mid: int, out: int):
        super().__init__()
        self.rebnconvin = ConvBnRelu(in_ch, out)
        self.rebnconv1 = ConvBnRelu(out, mid, dilation=1)
        self.rebnconv2 = ConvBnRelu(mid, mid, dilation=2)
        self.rebnconv3 = ConvBnRelu(mid, mid, dilation=4)
        self.rebnconv4 = ConvBnRelu(mid, mid, dilation=8)
        self.rebnconv3d = ConvBnRelu(2 * mid, mid, dilation=4)
        self.rebnconv2d = ConvBnRelu(2 * mid, mid, dilation=2)
        self.rebnconv1d = ConvBnRelu(2 * mid, out, dilation=1)

    def forward(self, x):
        hx_in = self.rebnconvin(x)
        h1 = self.rebnconv1(hx_in)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        d3 = self.rebnconv3d(torch.cat([h4, h3], dim=1))
        d2 = self.rebnconv2d(torch.cat([d3, h2], dim=1))
        d1 = self.rebnconv1d(torch.cat([d2, h1], dim=1))
        return d1 + hx_in


# stage plans: ((depth or None, mid, out) x 6 encoder, x 5 decoder); depth
# None = RSU4F. The channel plans are the originals'
U2NETP_PLAN = (
    ((7, 16, 64), (6, 16, 64), (5, 16, 64), (4, 16, 64), (None, 16, 64), (None, 16, 64)),
    ((None, 16, 64), (4, 16, 64), (5, 16, 64), (6, 16, 64), (7, 16, 64)),
)
U2NET_PLAN = (
    ((7, 32, 64), (6, 32, 128), (5, 64, 256), (4, 128, 512), (None, 256, 512), (None, 256, 512)),
    ((None, 256, 512), (4, 128, 256), (5, 64, 128), (6, 32, 64), (7, 16, 64)),
)


def _make_stage(spec, in_ch: int) -> nn.Module:
    depth, mid, out = spec
    return RSU4F(in_ch, mid, out) if depth is None else RSU(depth, in_ch, mid, out)


class U2Net(nn.Module):
    """U2NET / U2NETP: 6 encoder + 5 decoder RSU stages with deep side
    supervision; ``plan`` selects the channel configuration. ``forward``
    takes f32[B, 3, H, W] and returns the sigmoid probabilities (fused,
    side1 .. side6), each [B, 1, H, W]."""

    def __init__(self, plan=U2NETP_PLAN, in_ch: int = 3):
        super().__init__()
        enc, dec = plan
        outs = [spec[2] for spec in enc]
        ins = [in_ch] + outs[:5]
        for i in range(6):
            setattr(self, f"stage{i + 1}", _make_stage(enc[i], ins[i]))
        # decoder stage k (5 .. 1) reads the deeper output beside encoder k's
        deeper = outs[5]
        dec_outs = []
        for j, k in enumerate(range(5, 0, -1)):
            setattr(self, f"stage{k}d", _make_stage(dec[j], deeper + outs[k - 1]))
            deeper = dec[j][2]
            dec_outs.append(deeper)
        side_ins = dec_outs[::-1] + [outs[5]]  # d1 .. d5, e6
        for i, ch in enumerate(side_ins):
            setattr(self, f"side{i + 1}", nn.Conv2d(ch, 1, 3, padding=1))
        self.outconv = nn.Conv2d(6, 1, 1)

    def forward(self, x):
        e1 = self.stage1(x)
        e2 = self.stage2(_down(e1))
        e3 = self.stage3(_down(e2))
        e4 = self.stage4(_down(e3))
        e5 = self.stage5(_down(e4))
        e6 = self.stage6(_down(e5))
        d5 = self.stage5d(torch.cat([_up_to(e6, e5), e5], dim=1))
        d4 = self.stage4d(torch.cat([_up_to(d5, e4), e4], dim=1))
        d3 = self.stage3d(torch.cat([_up_to(d4, e3), e3], dim=1))
        d2 = self.stage2d(torch.cat([_up_to(d3, e2), e2], dim=1))
        d1 = self.stage1d(torch.cat([_up_to(d2, e1), e1], dim=1))
        sides = [_up_to(getattr(self, f"side{i + 1}")(s), d1) for i, s in enumerate((d1, d2, d3, d4, d5, e6))]
        fused = self.outconv(torch.cat(sides, dim=1))
        return tuple(torch.sigmoid(s) for s in (fused, *sides))


def U2NetLite(mid: int = 16, out: int = 64) -> U2Net:
    """U2NETP-shaped model; ``mid`` / ``out`` shrink it for tests."""
    if (mid, out) == (16, 64):
        return U2Net(U2NETP_PLAN)
    enc = tuple((d, mid, out) for d in (7, 6, 5, 4, None, None))
    dec = tuple((d, mid, out) for d in (None, 4, 5, 6, 7))
    return U2Net((enc, dec))


def U2NetFull() -> U2Net:
    """The full U2NET configuration (the reference's default SOD model)."""
    return U2Net(U2NET_PLAN)


def seeded_state_dict(model: nn.Module, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Deterministic weights for ``model`` from ``generator`` (CPU): conv
    weights normal with variance 1 / fan-in, small biases, and BatchNorm
    scales, shifts and running statistics away from the identity so that
    eval-mode normalization is exercised."""
    state = {}
    for name, value in model.state_dict().items():
        shape = value.shape
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros_like(value)
        elif ".bn_s1." in name and name.endswith("running_var"):
            state[name] = 0.5 + torch.rand(shape, generator=generator)
        elif ".bn_s1." in name and name.endswith("weight"):
            state[name] = 0.8 + 0.4 * torch.rand(shape, generator=generator)
        elif value.ndim == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            state[name] = torch.randn(shape, generator=generator) / fan_in**0.5
        else:  # conv and BatchNorm biases, running means
            state[name] = 0.1 * torch.randn(shape, generator=generator)
    return state
