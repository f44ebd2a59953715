"""U²-Net weights made from the seed on the device, over the reference
network's layers in ``state_dict`` order, so the port and the reference get
the same tensors. Drawn as the port's ``seeded_state_dict`` draws them (no
trained checkpoint is in the repository): convolution weights normal with
variance 1 / fan-in, BatchNorm scales uniform in 0.8..1.2 and running
variances in 0.5..1.5, convolution and BatchNorm biases and running means
normal with deviation 0.1. One normal and one uniform draw from a generator
on the run's device, in float32."""

from __future__ import annotations

import torch

from portbench.reference.models.u2net import U2Net


def u2net_state(seed: int, device, plan) -> dict[str, torch.Tensor]:
    """Weights of ``U2Net(plan)`` (the reference's channel plan tuples)."""
    with torch.device("meta"):
        net = U2Net(plan)
    leaves = list(net.state_dict().items())
    uniform = {k for k, _ in leaves if ".bn_s1." in k and k.endswith(("running_var", ".weight"))}
    normal = [v for k, v in leaves if v.is_floating_point() and k not in uniform]
    generator = torch.Generator(device=device).manual_seed(seed % 2**63)
    draws = {
        "normal": torch.randn(sum(v.numel() for v in normal), generator=generator, device=device),
        "uniform": torch.rand(sum(dict(leaves)[k].numel() for k in uniform), generator=generator, device=device),
    }
    state, offsets = {}, {"normal": 0, "uniform": 0}
    for name, value in leaves:
        if not value.is_floating_point():  # num_batches_tracked
            state[name] = torch.zeros(value.shape, dtype=value.dtype, device=device)
            continue
        kind = "uniform" if name in uniform else "normal"
        draw = draws[kind][offsets[kind] : offsets[kind] + value.numel()].reshape(value.shape)
        offsets[kind] += value.numel()
        if name.endswith("running_var"):
            state[name] = 0.5 + draw
        elif kind == "uniform":  # BatchNorm scales
            state[name] = 0.8 + 0.4 * draw
        elif value.ndim == 4:
            state[name] = draw / (value.shape[1] * value.shape[2] * value.shape[3]) ** 0.5
        else:  # biases, running means
            state[name] = 0.1 * draw
    return state
