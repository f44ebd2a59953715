"""Frame sequences (port of ``dynamicfuion_python_tpu/data/frame_sequence.py``):
a DeepDeform-layout sequence directory

    <seq>/color/000000.{jpg,png}   <seq>/depth/000000.png (u16 mm)
    <seq>/mask/...                 <seq>/intrinsics.txt

yielding per-frame numpy arrays, and a synthetic deforming surface.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from dynamicfuion_python_tpu_torch.data.camera import load_intrinsics_txt


@dataclass
class Frame:
    index: int
    depth: np.ndarray  # u16[H, W] (millimeters)
    color: np.ndarray | None  # u8[H, W, 3]
    mask: np.ndarray | None  # bool[H, W]


class FrameSequenceDataset:
    """Iterates a DeepDeform-layout sequence directory."""

    def __init__(
        self,
        sequence_directory: str | Path,
        start_at_frame: int = 0,
        run_until_frame: int | None = None,
        use_mask: bool = False,
        far_clip_mm: int = 0,
    ):
        self.directory = Path(sequence_directory)
        depth_dir = self.directory / "depth"
        if not depth_dir.is_dir():
            raise FileNotFoundError(f"no depth/ folder under {self.directory}")
        self.depth_paths = sorted(depth_dir.glob("*.png"))
        color_dir = self.directory / "color"
        self.color_paths = (
            sorted(list(color_dir.glob("*.jpg")) + list(color_dir.glob("*.png")))
            if color_dir.is_dir()
            else []
        )
        mask_dir = self.directory / "mask"
        self.mask_paths = sorted(mask_dir.glob("*.png")) if use_mask and mask_dir.is_dir() else []
        self.intrinsics = load_intrinsics_txt(self.directory / "intrinsics.txt")
        end = run_until_frame if run_until_frame is not None else len(self.depth_paths)
        self.frame_range = range(start_at_frame, min(end, len(self.depth_paths)))
        self.far_clip_mm = far_clip_mm

    def __len__(self) -> int:
        return len(self.frame_range)

    def __iter__(self):
        for i in self.frame_range:
            yield self.load_frame(i)

    def get_frame_graph(self, index: int) -> dict | None:
        """The precomputed deformation-graph blobs of a frame, or None.

        Blobs are named by the source frame number of the original capture
        (``..._000300_000600_geodesic_0.05.bin`` for a sequence whose first
        depth image is ``000300.png``), so a blob matches when its first
        number equals the positional index or the depth file's number."""
        from dynamicfuion_python_tpu_torch.apps.create_graph_data import load_graph_data

        graph_dir = self.directory / "graph_nodes"
        if not graph_dir.is_dir():
            return None
        accept = {index}
        if index < len(self.depth_paths):
            stem = self.depth_paths[index].stem
            if stem.isdigit():
                accept.add(int(stem))
        for path in sorted(graph_dir.glob("*_geodesic_*.bin")):
            pair, _, coverage = path.stem.rpartition("_geodesic_")
            numeric = [int(p) for p in pair.split("_") if p.isdigit()]
            if numeric and numeric[0] in accept:
                return load_graph_data(self.directory, pair, float(coverage))
        return None

    def load_frame(self, index: int) -> Frame:
        from PIL import Image

        depth = np.asarray(Image.open(self.depth_paths[index]), np.uint16)
        if self.far_clip_mm > 0:
            depth = np.where(depth > self.far_clip_mm, 0, depth).astype(np.uint16)
        color = None
        if index < len(self.color_paths):
            color = np.asarray(Image.open(self.color_paths[index]).convert("RGB"))
        mask = None
        if index < len(self.mask_paths):
            mask = np.asarray(Image.open(self.mask_paths[index])) > 0
            depth = np.where(mask, depth, 0).astype(np.uint16)
        return Frame(index=index, depth=depth, color=color, mask=mask)


class SyntheticBendingPlaneSequence:
    """Deterministic deforming-surface sequence rendered analytically: a plane
    at depth ``z`` bending with per-frame increasing curvature."""

    def __init__(
        self,
        frame_count: int = 8,
        image_size: tuple[int, int] = (240, 320),
        z: float = 1.0,
        bend_per_frame: float = 0.02,
        focal: float = 300.0,
    ):
        self.frame_count = frame_count
        h, w = image_size
        self.image_size = image_size
        self.intrinsics = np.asarray(
            [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32
        )
        self.z = z
        self.bend_per_frame = bend_per_frame

    def __len__(self):
        return self.frame_count

    def gt_surface_z(self, x: np.ndarray, y: np.ndarray, index: int) -> np.ndarray:
        bend = self.bend_per_frame * index
        return self.z + bend * (x + 0.3) ** 2

    def load_frame(self, index: int) -> Frame:
        h, w = self.image_size
        fx = self.intrinsics[0, 0]
        cx, cy = self.intrinsics[0, 2], self.intrinsics[1, 2]
        v, u = np.mgrid[0:h, 0:w].astype(np.float32)
        # solve z from the bending-surface equation along each pixel ray
        # (fixed-point iteration; converges fast for mild bending)
        z = np.full((h, w), self.z, np.float32)
        for _ in range(12):
            x = (u - cx) / fx * z
            y = (v - cy) / fx * z
            z = self.gt_surface_z(x, y, index).astype(np.float32)
        # limit to a finite patch
        x = (u - cx) / fx * z
        y = (v - cy) / fx * z
        inside = (np.abs(x) < 0.3) & (np.abs(y) < 0.3)
        depth = np.where(inside, (z * 1000.0), 0).astype(np.uint16)
        color = np.zeros((h, w, 3), np.uint8)
        color[..., 1] = np.where(inside, 180, 0)
        return Frame(index=index, depth=depth, color=color, mask=inside)

    def __iter__(self):
        for i in range(self.frame_count):
            yield self.load_frame(i)
