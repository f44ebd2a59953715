"""DeformNet weights made from the seed on the device: one draw from a
generator on the run's device, split into the layers, each scaled to
PyTorch's default bound for its layer (uniform in +-1 / sqrt(fan_in),
fan_in = the weight's dim 1 times its kernel size), in float32, the type
the networks run in. The layer list is the reference's DeformNet, so the
port and the reference get the same tensors."""

from __future__ import annotations

from pathlib import Path

import torch
import torch.nn as nn

from portbench.reference.models.deform_net import DeformNet
from portbench.reference.models.gn_point_cloud_optimizer import GnConfig


def deform_net_state(seed: int, device, use_mask: bool) -> dict[str, torch.Tensor]:
    with torch.device("meta"):
        net = DeformNet(use_mask=use_mask, num_nodes=1, gn_config=GnConfig())
    leaves = []
    for name, module in net.named_modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
            w = module.weight
            bound = 1.0 / (w.shape[1] * w[0, 0].numel()) ** 0.5
            leaves += [(f"{name}.weight", w.shape, bound), (f"{name}.bias", module.bias.shape, bound)]
    generator = torch.Generator(device=device).manual_seed(seed % 2**63)
    total = sum(shape.numel() for _, shape, _ in leaves)
    draw = torch.rand(total, generator=generator, device=device, dtype=torch.float32) * 2.0 - 1.0
    state, offset = {}, 0
    for name, shape, bound in leaves:
        state[name] = (draw[offset : offset + shape.numel()] * bound).reshape(shape)
        offset += shape.numel()
    return state


def save_state(state: dict, path: Path) -> Path:
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)
    return path
