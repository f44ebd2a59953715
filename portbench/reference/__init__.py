"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch paths that the cells compare (the single-device fusion loop with
and without the neural prior, DeformNet, the training step, and reading a
fusion checkpoint), which the benchmark runs beside the port to decide
``correct``. What no cell runs is left out: the port's process-group (SPMD)
branches, the renderer and rendered prior sources, weight and state
conversion from the JAX package, telemetry, the training loop, the
pipelines' command lines and the data terms other than the face term.

It imports nothing of the port and is never edited to follow it. On the
paths it keeps it departs from the port in three ways only:

  - kernels B1 (``ops/rasterize.py::rasterize_tiles``) and B2
    (``ops/mesh_expand.py::expand_project_faces``) run their plain PyTorch
    versions on every device; the CUDA wrappers are gone;
  - the contexts that turn TF32 off (``ops/segment_sum.py::fp32_matmuls``,
    ``models/deform_net.py::fp32_convolutions``, ``apps/train.py::fp32_step``)
    leave the precision to the caller, who sets FP32 for the reference and
    TF32 for its control (``portbench/check/precision.py``);
  - the package name in its imports.
"""
