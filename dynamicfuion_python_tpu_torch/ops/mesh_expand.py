"""Indexed mesh -> pixel-space face vertices + clip mask (kernel B2), and the
indexed-mesh rasterizer around it.

Port of the Pallas TPU kernel ``_expand_project``
(``dynamicfuion_python_tpu/ops/pallas/mesh_expand.py``), whose function is
``extract_face_vertices`` of the JAX rasterizer. The TPU kernel worked in
min-vertex-id face order (an ``ExpansionPlan``) to avoid XLA's per-row gather
cost; the CUDA kernel takes faces in any order, and
:func:`expand_project_faces` keeps the caller's, so the permutation back is
the identity. :func:`rasterize_indexed` runs the kernel on an
``ExpansionPlan``'s sorted faces, then the splat rasterizer, and maps the
fragments' face ids back to the caller's numbering, as the JAX package does.

:func:`expand_project_faces` launches the CUDA kernel (``csrc/mesh_expand.cu``)
for CUDA tensors and runs :func:`expand_project_faces_plain`, the same math
in plain PyTorch, for CPU tensors. :func:`launch_floor` launches an empty
kernel on a given grid (:func:`expand_grid` gives this kernel's), to time
what a launch alone costs.
"""

from __future__ import annotations

import ctypes

import torch

from dynamicfuion_python_tpu_torch.ops import native
from dynamicfuion_python_tpu_torch.utils import trace
from dynamicfuion_python_tpu_torch.utils.device import resolve_device

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int,  # verts, num_verts
    ctypes.c_void_p, ctypes.c_int,  # tris, num_faces
    ctypes.c_void_p, ctypes.c_float, ctypes.c_float,  # intrinsics, near, far
    ctypes.c_void_p, ctypes.c_void_p,  # out, valid
    ctypes.c_void_p,  # stream
]
_FLOOR_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # blocks, threads, stream
_THREADS = 256  # faces per block of the kernel


def expand_grid(num_faces: int) -> tuple[int, int]:
    """(blocks, threads per block) of the kernel's launch for ``num_faces``."""
    return -(-num_faces // _THREADS), _THREADS


def expand_project_faces_plain(
    vertices: torch.Tensor,
    triangles: torch.Tensor,
    intrinsics: torch.Tensor,
    near: float = 0.05,
    far: float = 10.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """vertices f32[V, 3], triangles int[F, 3] -> (face vertices f32[F, 3, 3]
    as (u, v, z) per corner, valid bool[F]); a face is valid when all three
    corners lie strictly between ``near`` and ``far``."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    f = triangles.shape[0]
    tri = triangles.long().clamp(0, vertices.shape[0] - 1)
    cols = []
    valid = None
    for i in range(3):
        vi = vertices[tri[:, i]]
        z = vi[:, 2]
        ok = (z > near) & (z < far)
        valid = ok if valid is None else (valid & ok)
        safe_z = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
        cols.append(vi[:, 0] / safe_z * fx + cx)
        cols.append(vi[:, 1] / safe_z * fy + cy)
        cols.append(z)
    return torch.stack(cols, dim=-1).reshape(f, 3, 3), valid


def expand_project_faces_cuda(
    vertices: torch.Tensor,
    triangles: torch.Tensor,
    intrinsics: torch.Tensor,
    near: float = 0.05,
    far: float = 10.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel on card tensors; same contract as the plain version."""
    dev = vertices.device
    if vertices.dtype != torch.float32 or vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError(f"vertices must be f32[V, 3], got {vertices.dtype}{list(vertices.shape)}")
    if triangles.dtype != torch.int32 or triangles.ndim != 2 or triangles.shape[1] != 3:
        raise ValueError(f"triangles must be int32[F, 3], got {triangles.dtype}{list(triangles.shape)}")
    if intrinsics.dtype != torch.float32 or tuple(intrinsics.shape) != (3, 3):
        raise ValueError("intrinsics must be f32[3, 3]")
    for name, t in (("vertices", vertices), ("triangles", triangles), ("intrinsics", intrinsics)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, vertices on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vertices.shape[0] == 0:
        raise ValueError("vertices must not be empty")
    f = triangles.shape[0]
    out = torch.empty((f, 3, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((f,), dtype=torch.bool, device=dev)
    status = native.entry_point("mesh_expand", _ARGTYPES)(
        vertices.data_ptr(), vertices.shape[0],
        triangles.data_ptr(), f,
        intrinsics.data_ptr(), float(near), float(far),
        out.data_ptr(), valid.data_ptr(),
        native.stream_handle(dev),
    )
    native.check(status, "mesh_expand")
    trace.count("b2.launches")
    return out, valid


def launch_floor(blocks: int, threads: int, device) -> None:
    """Launch the empty kernel of ``csrc/mesh_expand.cu`` on a grid of
    ``blocks`` blocks of ``threads`` threads. For timing only: it computes
    nothing and is counted nowhere."""
    status = native.entry_point("mesh_expand", _FLOOR_ARGTYPES, "launch_floor")(
        int(blocks), int(threads), native.stream_handle(device)
    )
    native.check(status, "launch_floor")


def expand_project_faces(
    vertices: torch.Tensor,
    triangles: torch.Tensor,
    intrinsics: torch.Tensor,
    near: float = 0.05,
    far: float = 10.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Indexed mesh -> (face vertices f32[F, 3, 3], valid bool[F],
    sorted_to_original int64[F]) in the caller's face order, so the last
    is the identity. CUDA tensors go to the kernel; CPU tensors to the plain
    version."""
    if vertices.device.type == "cuda":
        fv, valid = expand_project_faces_cuda(vertices, triangles, intrinsics, near, far)
    elif vertices.device.type == "cpu":
        fv, valid = expand_project_faces_plain(vertices, triangles, intrinsics, near, far)
    else:
        raise ValueError(f"unsupported device {vertices.device}")
    return fv, valid, torch.arange(triangles.shape[0], device=vertices.device)


class ExpansionPlan:
    """The static face order of an indexed mesh for :func:`rasterize_indexed`:
    ``perm`` sorts the faces by their smallest vertex id (a stable sort), so
    ``sorted_triangles`` = ``faces[perm]``, and ``sorted_to_original`` maps a
    sorted face id back to the caller's (it is ``perm``).

    The JAX package's plan also holds window tables (``loc``, ``starts``,
    ``window_groups``): they exist only to feed the TPU kernel's DMA windows
    of nearby vertices. The CUDA kernel gathers each face's corners itself,
    so they are not kept. The order stays because it decides which face
    wins a depth tie (the lower sorted id).
    """

    def __init__(self, faces, num_vertices: int, device=None):
        faces = torch.as_tensor(faces).to(resolve_device(device), torch.int32)
        self.num_faces = faces.shape[0]
        self.num_vertices = int(num_vertices)
        self.perm = torch.sort(torch.amin(faces, dim=1), stable=True).indices
        self.sorted_to_original = self.perm
        self.sorted_triangles = faces[self.perm].contiguous()


def _remap_fragment_ids(frag_indices: torch.Tensor, s2o: torch.Tensor) -> torch.Tensor:
    """Sorted face ids -> the caller's face ids (-1 stays -1)."""
    remapped = s2o[torch.clamp(frag_indices, min=0).long()].to(frag_indices.dtype)
    return torch.where(frag_indices >= 0, remapped, frag_indices)


def rasterize_indexed(
    vertices: torch.Tensor,
    plan: ExpansionPlan,
    intrinsics: torch.Tensor,
    image_size: tuple[int, int],
    faces_per_pixel: int = 1,
    near: float = 0.05,
    far: float = 10.0,
    quad_cap: int | None = None,
    hex_cap: int | None = None,
    oct_cap: int | None = None,
    max_large_faces: int = 512,
):
    """Indexed-mesh rasterization: kernel B2 on the plan's sorted faces, the
    splat rasterizer (:func:`..rasterize.rasterize_splat`, perspective-correct,
    no culling, its default tier caps where a cap is None) in that order,
    then the fragments' face ids mapped back to the caller's numbering.
    Returns (Fragments, overflow)."""
    from dynamicfuion_python_tpu_torch.ops.rasterize import rasterize_splat

    face_vertices, valid, _ = expand_project_faces(vertices, plan.sorted_triangles, intrinsics, near, far)
    frag, overflow = rasterize_splat(
        face_vertices, valid, image_size, faces_per_pixel=faces_per_pixel, perspective_correct=True,
        cull_back_faces=False, quad_cap=quad_cap, hex_cap=hex_cap, oct_cap=oct_cap,
        max_large_faces=max_large_faces, return_overflow=True,
    )
    return frag._replace(face_indices=_remap_fragment_ids(frag.face_indices, plan.sorted_to_original)), overflow
