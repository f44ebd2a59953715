"""Faults planted in the port's SOD path underneath a run of
``sod.u2net320``, for the tests and the card's runs; each must make
``correct`` come out false:

  - ``bilinear_resize``: the loop's resizes use Pillow's bilinear filter in
    place of bicubic (fails ``input``);
  - ``batchnorm_training``: U²-Net's BatchNorm runs in training mode, on
    the batch's statistics (fails ``prob``);
  - ``previous_masks``: a batch's masks are written from the batch before's
    output (fails ``mask``).
"""

from __future__ import annotations

from portbench.faults import _patched


def _bilinear_resize(resize_images):
    def call(images, size_hw, kind="bicubic"):
        return resize_images(images, size_hw, "bilinear")
    return call


def _batchnorm_training(forward):
    def call(self, x):
        self.train()
        try:
            return forward(self, x)
        finally:
            self.eval()
    return call


def _previous_masks(postprocess):
    before = []

    def call(*args, **kwargs):
        masks = postprocess(*args, **kwargs)
        before.append(masks)
        return before.pop(0) if len(before) > 1 else masks
    return call


def planted(fault: str):
    """A context in which the port's SOD path runs with ``fault``."""
    from dynamicfuion_python_tpu_torch.apps import sod
    from dynamicfuion_python_tpu_torch.models.u2net import U2Net

    return {
        "bilinear_resize": lambda: _patched(sod, "resize_images", _bilinear_resize),
        "batchnorm_training": lambda: _patched(U2Net, "forward", _batchnorm_training),
        "previous_masks": lambda: _patched(sod, "postprocess", _previous_masks),
    }[fault]()
