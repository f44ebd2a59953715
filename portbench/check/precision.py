"""The precision the reference computes in: FP32 with TF32 off, as the
configurations state; its control, TF32 on for cuBLAS and cuDNN, the next
precision below."""

from __future__ import annotations

import contextlib

import torch


def set_fp32() -> None:
    """The configurations' precision for the whole run: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def precision(tf32: bool):
    previous = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = previous
