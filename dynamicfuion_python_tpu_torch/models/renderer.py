"""Forward mesh renderer, RGB-D (port of
``dynamicfuion_python_tpu/models/renderer.py``).

Renders a camera-space triangle mesh to a color image and a depth image: the
mesh's faces are expanded to pixel space by kernel B2
(``extract_face_vertices``), rasterized by the binned rasterizer, whose phase
2 is kernel B1, at one fragment per pixel and up to 1024 faces per 16 px
bin, and shaded with interpolated vertex colors or, without them, Lambertian
shading of the area-weighted vertex normals. The pipeline renders the warped
canonical mesh with it for the neural prior's rendered source image and the
rendered-mesh recorder; the visualizer renders recorded meshes.
"""

from __future__ import annotations

import torch

from dynamicfuion_python_tpu_torch.ops.normals import mesh_vertex_normals
from dynamicfuion_python_tpu_torch.ops.rasterize import extract_face_vertices, rasterize_binned
from dynamicfuion_python_tpu_torch.ops.shading import normal_shader, vertex_color_shader
from dynamicfuion_python_tpu_torch.utils.device import resolve_device


class MeshRenderer:
    """Renders camera-space triangle meshes to color + depth images on one
    device (the CUDA card unless the caller passes ``device="cpu"``)."""

    def __init__(
        self,
        image_size: tuple[int, int],
        intrinsics,
        tile_size: int = 16,
        max_faces_per_bin: int = 1024,
        device=None,
    ):
        self.device = resolve_device(device)
        self.image_size = (int(image_size[0]), int(image_size[1]))
        self.intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32).to(self.device).contiguous()
        self.tile_size = tile_size
        self.max_faces_per_bin = max_faces_per_bin

    def render_mesh(self, vertices, triangles, vertex_colors=None):
        """vertices f32[V, 3] (camera space), triangles int[F, 3] and
        optional vertex_colors f32[V, 3] in [0, 1], on the renderer's device
        -> (color f32[H, W, 3], depth f32[H, W] in meters, 0 = miss). No
        value crosses to the host."""
        triangles = triangles.to(torch.int32).contiguous()
        fv, valid = extract_face_vertices(vertices.contiguous(), triangles, self.intrinsics, self.image_size)
        frag = rasterize_binned(
            fv, valid, self.image_size, faces_per_pixel=1, cull_back_faces=False,
            tile_size=self.tile_size, max_faces_per_bin=self.max_faces_per_bin,
        )
        depth = torch.where(frag.face_indices[..., 0] >= 0, frag.depths[..., 0], 0.0)
        if vertex_colors is None:
            color = normal_shader(frag, mesh_vertex_normals(vertices, triangles), triangles)
        else:
            color = vertex_color_shader(frag, vertex_colors, triangles)
        return color, depth
