"""Headless run visualizer: renders recorded telemetry to images (port of
``dynamicfuion_python_tpu/apps/visualizer.py``).

``render_run`` renders each recorded ``*_{warped,canonical}_mesh.ply`` with
the port's ``MeshRenderer`` (normal shading, on the card unless the caller
asks for the CPU) from a camera orbiting the mesh, into PNGs written by the
telemetry's own encoder, plus an ``index.html`` contact sheet.
``render_gn_playback`` draws each recorded GN iteration's warped node cloud
with its losses (host-side, from the ``*_gn_iterations.npz`` records; it
needs Pillow) and a ``gn_playback.html`` that steps through them with the
arrow keys.

Run: python -m dynamicfuion_python_tpu_torch.apps.visualizer --run <telemetry_dir> \\
        [--out <dir>] [--size 480x640] [--orbit-degrees 20] [--gn-playback] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.models.renderer import MeshRenderer
from dynamicfuion_python_tpu_torch.ops.camera import transform_points
from dynamicfuion_python_tpu_torch.utils.telemetry import read_ply, write_png


def _look_at_transform(center: np.ndarray, distance: float, angle_deg: float) -> np.ndarray:
    """World -> camera transform of a camera orbiting ``center`` in the XZ
    plane at ``distance``, looking at it."""
    a = math.radians(angle_deg)
    eye = center + distance * np.asarray([math.sin(a), 0.0, -math.cos(a)])
    forward = center - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross([0.0, 1.0, 0.0], forward)
    right = right / (np.linalg.norm(right) + 1e-12)
    up = np.cross(forward, right)
    rot = np.stack([right, up, forward])  # world -> camera rows
    mat = np.eye(4, dtype=np.float32)
    mat[:3, :3] = rot
    mat[:3, 3] = -rot @ eye
    return mat


def render_run(
    run_dir: str | Path,
    out_dir: str | Path | None = None,
    image_size=(480, 640),
    orbit_degrees: float = 25.0,
    kinds=("warped", "canonical"),
    device=None,
) -> list[str]:
    """Render every recorded mesh of ``kinds`` in ``run_dir`` to
    ``<out_dir or run_dir/renders>/<ply stem>.png``; returns the file names."""
    run_dir = Path(run_dir)
    out = Path(out_dir) if out_dir else run_dir / "renders"
    out.mkdir(parents=True, exist_ok=True)
    h, w = image_size
    focal = 1.1 * min(h, w)
    intrinsics = np.asarray([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    renderer = MeshRenderer((h, w), intrinsics, device=device)
    dev = renderer.device
    written = []
    for kind in kinds:
        for ply in sorted(run_dir.glob(f"*_{kind}_mesh.ply")):
            verts, faces = read_ply(ply)
            if len(verts) == 0:
                continue
            center = verts.mean(axis=0)
            extent = float(np.linalg.norm(verts - center, axis=1).max())
            cam = _look_at_transform(center, 2.5 * extent + 1e-3, orbit_degrees)
            cam_verts = transform_points(torch.as_tensor(verts, device=dev), torch.as_tensor(cam, device=dev))
            color, _ = renderer.render_mesh(cam_verts, torch.as_tensor(faces.astype(np.int32), device=dev))
            img = (np.clip(color.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
            png = out / (ply.stem + ".png")
            write_png(png, img)
            written.append(png.name)
    html = "<html><body style='background:#222'>" + "".join(
        f"<div style='display:inline-block;margin:4px;text-align:center;"
        f"color:#ccc'><img src='{name}' width='320'/><br/>{name}</div>"
        for name in written
    ) + "</body></html>"
    (out / "index.html").write_text(html)
    return written


def render_gn_playback(
    run_dir: str | Path,
    out_dir: str | Path | None = None,
    image_size=(360, 480),
    point_px: int = 2,
) -> dict[str, list[str]]:
    """For every ``*_gn_iterations.npz`` record, the warped node cloud of
    each GN iteration as a PNG annotated with its losses (an orthographic
    view framed once per frame), and ``gn_playback.html``. Returns the
    image names per frame."""
    from PIL import Image, ImageDraw

    run_dir = Path(run_dir)
    out = Path(out_dir) if out_dir else run_dir / "gn_playback"
    out.mkdir(parents=True, exist_ok=True)
    h, w = image_size
    frames: dict[str, list[str]] = {}
    for npz_path in sorted(run_dir.glob("*_gn_iterations.npz")):
        rec = np.load(npz_path)
        if "node_translations" not in rec or "node_positions" not in rec:
            continue
        positions = rec["node_positions"]  # [N, 3] canonical
        translations = rec["node_translations"]  # [I, N, 3]
        data_losses = rec["data_losses"]
        arap_losses = rec["arap_losses"]
        frame_name = npz_path.stem.split("_")[0]
        all_pts = positions[None] + translations
        lo = all_pts.reshape(-1, 3).min(axis=0)
        hi = all_pts.reshape(-1, 3).max(axis=0)
        span = np.maximum(hi - lo, 1e-6)
        names = []
        for i in range(translations.shape[0]):
            pts = positions + translations[i]
            u = ((pts[:, 0] - lo[0]) / span[0] * (w - 20) + 10).astype(int)
            v = ((pts[:, 1] - lo[1]) / span[1] * (h - 20) + 10).astype(int)
            depth01 = (pts[:, 2] - lo[2]) / span[2]
            img = Image.new("RGB", (w, h), (20, 20, 24))
            draw = ImageDraw.Draw(img)
            for x, y, d in zip(u, v, depth01):
                c = int(80 + 175 * (1 - d))
                draw.ellipse((x - point_px, y - point_px, x + point_px, y + point_px), fill=(c, int(0.6 * c), 255 - c))
            draw.text(
                (8, 4),
                f"frame {frame_name} GN iter {i}: data {float(data_losses[i]):.5f} arap {float(arap_losses[i]):.5f}",
                fill=(220, 220, 220),
            )
            name = f"{frame_name}_gn_iter_{i:02d}.png"
            img.save(out / name)
            names.append(name)
        if names:
            frames[frame_name] = names
    groups = json.dumps(frames)
    html = (
        "<html><body style='background:#111;color:#ccc;font-family:monospace'>"
        "<div id='label'></div><img id='view' style='width:640px'/>"
        "<p>left/right: GN iteration &nbsp; up/down: frame</p>"
        f"<script>const groups={groups};"
        "const keys=Object.keys(groups);let f=0,i=0;"
        "function show(){const g=groups[keys[f]];i=Math.max(0,Math.min(i,"
        "g.length-1));document.getElementById('view').src=g[i];"
        "document.getElementById('label').textContent="
        "`frame ${keys[f]} iter ${i+1}/${g.length}`;}"
        "document.addEventListener('keydown',e=>{"
        "if(e.key==='ArrowRight')i++;if(e.key==='ArrowLeft')i--;"
        "if(e.key==='ArrowUp'){f=Math.min(f+1,keys.length-1);i=0;}"
        "if(e.key==='ArrowDown'){f=Math.max(f-1,0);i=0;}show();});"
        "if(keys.length)show();</script></body></html>"
    )
    (out / "gn_playback.html").write_text(html)
    return frames


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kwargs = {}
    gn_playback = False
    device = None  # the CUDA card
    it = iter(argv)
    for arg in it:
        if arg == "--run":
            kwargs["run_dir"] = next(it)
        elif arg == "--out":
            kwargs["out_dir"] = next(it)
        elif arg == "--size":
            h, w = next(it).split("x")
            kwargs["image_size"] = (int(h), int(w))
        elif arg == "--orbit-degrees":
            kwargs["orbit_degrees"] = float(next(it))
        elif arg == "--gn-playback":
            gn_playback = True
        elif arg == "--device":
            device = next(it)
    if gn_playback:
        kwargs.pop("orbit_degrees", None)
        frames = render_gn_playback(**kwargs)
        print(f"gn playback: {sum(len(v) for v in frames.values())} iteration renders across {len(frames)} frames")
        return frames
    written = render_run(**kwargs, device=device)
    print(f"rendered {len(written)} images")
    return written


if __name__ == "__main__":
    main()
