"""MaskNet, per-pixel correspondence weights (port of
``dynamicfuion_python_tpu/models/mask_net.py``): two transposed convs
upsample PWC-Net's 565-channel features2 to full resolution (565 -> 32 -> 16
channels), concatenated with the 12-channel [source rgbxyz, warped target
rgb, target matches] stack, then one conv block and three residual blocks ->
sigmoid weight map. NCHW inside, NHWC at the boundary; submodule names are
the reference checkpoint's (``upconv1``, ``upconv2``, ``model.0.0.0``,
``model.{1,2,3}.block{0,1}.0``, ``model.4``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.models.pwcnet import PhaseConvTranspose2d, to_nchw, to_nhwc

FEATURES2_CHANNELS = 565
INPUT_CHANNELS = 12


class ResBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.block0 = nn.Sequential(nn.Conv2d(features, features, 3, padding=1), nn.ReLU())
        self.block1 = nn.Sequential(nn.Conv2d(features, features, 3, padding=1))

    def forward(self, x):
        return torch.relu(self.block1(self.block0(x)) + x)


class MaskNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.upconv1 = PhaseConvTranspose2d(FEATURES2_CHANNELS, 32)
        self.upconv2 = PhaseConvTranspose2d(32, 16)
        self.model = nn.Sequential(
            nn.Sequential(nn.Sequential(nn.Conv2d(16 + INPUT_CHANNELS, 16, 3, padding=1), nn.ReLU())),
            ResBlock(16),
            ResBlock(16),
            ResBlock(16),
            nn.Conv2d(16, 1, 3, padding=1),
        )

    def forward_nchw(self, features2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        f = self.upconv2(self.upconv1(features2))
        return torch.sigmoid(self.model(torch.cat([f, x], dim=1)))

    def forward(self, features2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """features2 f32[B, H/4, W/4, 565], x f32[B, H, W, 12] (NHWC) ->
        weights f32[B, H, W, 1]."""
        return to_nhwc(self.forward_nchw(to_nchw(features2), to_nchw(x)))
