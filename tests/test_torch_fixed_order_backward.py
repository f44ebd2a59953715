"""The training path's fixed-order backwards on the CPU: the node gathers
(``ops/warp.py::gather_rows``, backward a ``segment_sum``) and the flow
upsampling (``models/pwcnet.py::bilinear_resize``, backward the transposed
resize on the card). On the CPU both give autograd's own bits; the plain
transposed resize, the card's backward, is held within 1e-6 of the largest
entry of autograd's. The card's side is in tests/test_torch_kernels_gpu.py."""

import pytest
import torch
import torch.nn.functional as F

from dynamicfuion_python_tpu_torch.apps.train import backward_census
from dynamicfuion_python_tpu_torch.models import pwcnet
from dynamicfuion_python_tpu_torch.ops.warp import gather_rows

# (input size, output size): PWC-Net's flow2 to the 448x640 training crop,
# and odd sizes that are no multiple of each other
RESIZES = [((112, 160), (448, 640)), ((7, 13), (30, 41))]


def test_gather_rows_gradient_is_index_selects():
    """A million anchor indices into 128 node rotations (~7,800 duplicates
    per row): the gradient equals autograd's ``index_select`` gradient bit
    for bit, and so does the forward."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((128, 3, 3), generator=gen, requires_grad=True)
    index = torch.randint(0, 128, (250_000, 4), generator=gen)
    grad = torch.randn((250_000, 4, 3, 3), generator=gen)
    got_rows = gather_rows(table, index)
    (got,) = torch.autograd.grad(got_rows, table, grad)
    want_rows = torch.index_select(table, 0, index.reshape(-1)).reshape(250_000, 4, 3, 3)
    (want,) = torch.autograd.grad(want_rows, table, grad)
    assert torch.equal(got_rows, want_rows)
    assert torch.equal(got, want)


def test_gather_rows_without_gradient_is_index_select():
    table = torch.randn((16, 3))
    index = torch.tensor([[3, 3], [0, 15]])
    rows = gather_rows(table, index)
    assert rows.grad_fn is None and torch.equal(rows, table[index])


@pytest.mark.parametrize("sizes", RESIZES, ids=lambda s: "x".join(map(str, s)))
def test_bilinear_resize_is_interpolates(sizes):
    """Forward bit-equal to ``F.interpolate``; the CPU backward is
    autograd's own, bit for bit."""
    size_in, size_out = sizes
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 2, *size_in), generator=gen, requires_grad=True)
    grad = torch.randn((2, 2, *size_out), generator=gen)
    got = pwcnet.bilinear_resize(x, size_out)
    want = F.interpolate(x, size=size_out, mode="bilinear", align_corners=False)
    assert got.grad_fn.name() == "_BilinearResizeBackward"
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, x, grad)[0], torch.autograd.grad(want, x, grad)[0])


@pytest.mark.parametrize("sizes", RESIZES, ids=lambda s: "x".join(map(str, s)))
def test_transposed_resize_matches_autograd(sizes):
    """The card's backward form, run on the CPU: within 1e-6 of the largest
    entry of autograd's ``upsample_bilinear2d_backward`` (the same sums in
    another order)."""
    size_in, size_out = sizes
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((4, 2, *size_in), generator=gen, requires_grad=True)
    grad = torch.randn((4, 2, *size_out), generator=gen)
    (want,) = torch.autograd.grad(F.interpolate(x, size=size_out, mode="bilinear", align_corners=False), x, grad)
    got = pwcnet.bilinear_resize_backward(grad, size_in)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_upsample_flow_to_full_keeps_its_bits():
    """PWC-Net's flow2 [B, h, w, 2] to full resolution, times 20: the
    parent's expression bit for bit, with the fixed-order backward node."""
    flow2 = torch.randn((2, 16, 32, 2), generator=torch.Generator().manual_seed(3), requires_grad=True)
    got = pwcnet.upsample_flow_to_full(flow2, (64, 128))
    up = F.interpolate(flow2.permute(0, 3, 1, 2).contiguous(), size=(64, 128), mode="bilinear", align_corners=False)
    assert torch.equal(got, up.permute(0, 2, 3, 1).contiguous() * 20.0)
    assert "_BilinearResizeBackward" in backward_census(got.sum())
