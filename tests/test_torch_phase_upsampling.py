"""PWC-Net's and MaskNet's 2x upsampling (``models/pwcnet.py``): the card's
form, four 2x2 convolutions over the output's phases, against
``F.conv_transpose2d`` in f64 on CPU tensors at each layer's channel counts
(a small image), within 1e-6 of the largest entry in f32 and 1e-12 in f64;
on the CPU the module is ``nn.ConvTranspose2d`` bit for bit."""

import pytest
import torch
import torch.nn.functional as F

from dynamicfuion_python_tpu_torch.models.mask_net import FEATURES2_CHANNELS, MaskNet
from dynamicfuion_python_tpu_torch.models.pwcnet import Decoder, PhaseConvTranspose2d, upsample_by_phases

# (module, input channels, output channels) of every upsampling layer
LAYERS = {
    "decoder_upflow": (2, 2),
    "decoder5_upfeat": (Decoder(5).moduleUpfeat.in_channels, 2),
    "decoder2_upfeat": (Decoder(2).moduleUpfeat.in_channels, 2),
    "masknet_upconv1": (FEATURES2_CHANNELS, 32),
    "masknet_upconv2": (32, 16),
}
TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_phases_match_conv_transpose(layer, dtype):
    cin, cout = LAYERS[layer]
    gen = torch.Generator().manual_seed(3)
    module = PhaseConvTranspose2d(cin, cout).to(dtype)
    x = torch.randn((2, cin, 7, 10), generator=gen, dtype=dtype)
    with torch.no_grad():
        want = F.conv_transpose2d(x.double(), module.weight.double(), module.bias.double(), stride=2, padding=1)
        got = upsample_by_phases(x, module.weight, module.bias)
        assert got.shape == want.shape == (2, cout, 14, 20) and got.dtype == dtype
        assert float((got.double() - want).abs().max()) <= TOL[dtype] * float(want.abs().max())
        # the CPU runs the module's own forward
        assert torch.equal(module(x), F.conv_transpose2d(x, module.weight, module.bias, stride=2, padding=1))


def test_the_networks_upsample_by_phases():
    """Every transposed convolution of PWC-Net's decoders and of MaskNet is
    the phase module (4x4, stride 2, padding 1)."""
    modules = [m for net in (Decoder(3), MaskNet()) for m in net.modules() if isinstance(m, torch.nn.ConvTranspose2d)]
    assert len(modules) == 4
    assert all(isinstance(m, PhaseConvTranspose2d) and m.kernel_size == (4, 4) and m.stride == (2, 2)
               and m.padding == (1, 1) for m in modules)
