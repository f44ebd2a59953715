"""Faults planted in the port underneath a run, for the tests and for
``control.py --fault``: each must make ``correct`` come out false.

  - ``unchanged_frame``: the fit returns the field it was given;
  - ``altered_frame``: the fit's node translations moved 0.1 mm;
  - ``unchanged_step``: a training step leaves the weights as they were;
  - ``half_batch``: the step's loss over the first half of the batch.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _unchanged_frame(fit):
    def call(field, *args, **kwargs):
        return field, fit(field, *args, **kwargs)[1]
    return call


def _altered_frame(fit):
    def call(*args, **kwargs):
        field, diagnostics = fit(*args, **kwargs)
        return field.replace(node_translations=field.node_translations + 1e-4), diagnostics
    return call


def _unchanged_step(make_train_step):
    def make(model, optimizer, stage, scheduler=None):
        step = make_train_step(model, optimizer, stage, scheduler)

        def call(batch, events=None):
            before = {k: p.detach().clone() for k, p in model.named_parameters()}
            out = step(batch, events)
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(before[k])
            return out
        return call
    return make


def _half_batch(forward_and_loss):
    def call(model, batch, stage):
        b = batch["source"].shape[0] // 2
        return forward_and_loss(model, {k: v[:b] if torch.is_tensor(v) and v.ndim else v for k, v in batch.items()},
                                stage)
    return call


def planted(fault: str):
    """A context in which the port runs with ``fault``."""
    from dynamicfuion_python_tpu_torch.apps import fusion_pipeline, train

    return {
        "unchanged_frame": lambda: _patched(fusion_pipeline, "fit_to_image", _unchanged_frame),
        "altered_frame": lambda: _patched(fusion_pipeline, "fit_to_image", _altered_frame),
        "unchanged_step": lambda: _patched(train, "make_train_step", _unchanged_step),
        "half_batch": lambda: _patched(train, "_forward_and_loss", _half_batch),
    }[fault]()
