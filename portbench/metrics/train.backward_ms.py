"""Backward ms of a training step (CUDA events of ``make_train_step``,
``events=``), the median over the window's steps."""


def read(trace):
    return trace.get("backward_ms")
