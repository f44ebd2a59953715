"""PyTorch/CUDA port of the dynamic non-rigid fusion engine.

Mirrors the layout of ``dynamicfuion_python_tpu`` (the JAX reference) so each
module's counterpart sits at the same relative path. Plain tensor code is
PyTorch; the two rasterization kernels are hand-written CUDA for Hopper
(``csrc/``), each with a plain PyTorch version beside its wrapper.

Entry points (``FusionPipeline``, ``fit_to_image``, ``VoxelBlockGrid.create``)
run on the CUDA card unless the caller passes ``device="cpu"``.

Package layout:
  ops/       stateless tensor functions: linalg, KNN, anchors, warping,
             marching cubes, rasterization (+ its CUDA kernels)
  models/    warp fields, voxel block grid, Gauss-Newton fitter
  data/      synthetic frame sequence
  utils/     config tree, device selection, JAX-state conversion
  apps/      fusion pipeline
  csrc/      CUDA C++ sources of the hand-written kernels
"""

__version__ = "0.1.0"
