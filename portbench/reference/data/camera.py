"""Camera intrinsics IO (port of ``dynamicfuion_python_tpu/data/camera.py``:
a 4x4 or 3x3 text matrix whose upper-left 3x3 is the pinhole matrix)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_intrinsics_txt(path: str | Path) -> np.ndarray:
    """Load a DeepDeform ``intrinsics.txt`` -> f32[3, 3]."""
    mat = np.loadtxt(str(path), dtype=np.float64)
    if mat.shape == (4, 4):
        mat = mat[:3, :3]
    if mat.shape != (3, 3):
        raise ValueError(f"unexpected intrinsics shape {mat.shape} in {path}")
    return mat.astype(np.float32)
