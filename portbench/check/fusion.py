"""The fusion loop's comparison: pose, node transforms, TSDF and canonical
mesh of the port against the reference's, frame by frame.

The loop is a chain of hundreds of frames, each starting from the state the
last one left, so the reference cannot redo a window in less than the
window (its rasterizer runs plain). It runs its own chain from the raw
frames (initialization, the warm-up frames and the window's frames up to an
early one drawn from the seed) and compares at the end of the warm-up and
at that frame; and for each further sampled frame of the window it follows
the port one step: it loads the port's state before that frame from the
port's fusion checkpoint (the NTIO files the JAX package reads too) and
runs the frame itself.

Every copy the check keeps is on the host, so the card's memory peak is
the program's own.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from portbench.check.precision import precision
from portbench.reference.apps.fusion_pipeline import FusionPipeline
from portbench.reference.models.deform_net import DeformNet
from portbench.reference.settings import Parameters
from portbench.reference.utils.config import apply_overrides
from portbench.reference.utils.tensor_io import load_fusion_checkpoint

# the numbers compared, each the worst over the frames checked: camera pose
# entries, node rotation entries, node translations (m), TSDF values
# (truncation units) and weights of the observed voxels, mesh vertices (m);
# with the neural prior also DeformNet's flow (px) and mask, and the prior's
# Gauss-Newton node rotations and translations (m). A cell's limits file
# names the ones it compares
NAMES = ("pose", "nodes_r", "nodes_t", "tsdf", "weight", "mesh", "flow", "mask", "prior_r", "prior_t")
PRIOR = {"flow": "flows", "mask": "mask_prediction", "prior_r": "node_rotations", "prior_t": "node_translations"}


@contextlib.contextmanager
def prior_outputs(deform_net_class, into: dict):
    """While open, DeformNet's forward keeps host copies of what the prior
    reads from it: the finest flow, the mask, the solve's node transforms."""
    forward = deform_net_class.forward

    def recorded(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        for name, field in PRIOR.items():
            value = getattr(out, field)
            into[name] = _host_copy(value[0] if field == "flows" else value)
        return out

    deform_net_class.forward = recorded
    try:
        yield into
    finally:
        deform_net_class.forward = forward


def _host_copy(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.detach().to("cpu", copy=True)


def _cloned(obj):
    """A frozen dataclass with every tensor field copied to the host."""
    return dataclasses.replace(obj, **{
        f.name: _host_copy(getattr(obj, f.name))
        for f in dataclasses.fields(obj) if isinstance(getattr(obj, f.name), torch.Tensor)
    })


def snapshot(pipe) -> dict:
    """What a fusion checkpoint needs to resume ``pipe`` and what the
    comparison reads, as host copies (a port's or a reference's
    pipeline)."""
    previous = pipe.previous_depth
    return {
        "volume": _cloned(pipe.volume),
        "warp_field": _cloned(pipe.warp_field),
        "extrinsics": _host_copy(pipe.extrinsics),
        "previous_depth": None if previous is None else _host_copy(previous),
        "frames_processed": int(pipe.frames_processed),
        "mesh_state": {"v_cap": int(pipe._mesh_v_cap), "t_cap": int(pipe._mesh_t_cap),
                       "count_host": [int(c) for c in pipe._count_host]},
        "mesh": (_host_copy(pipe.canonical_vertices),
                 _host_copy(pipe.canonical_triangles[: pipe.canonical_triangle_count])),
    }


def _host(state: dict) -> dict:
    v = state["volume"]
    verts, faces = state["mesh"]
    return {
        "pose": state["extrinsics"].double().cpu().numpy(),
        "nodes_r": state["warp_field"].node_rotations.double().cpu().numpy(),
        "nodes_t": state["warp_field"].node_translations.double().cpu().numpy(),
        "keys": v.slot_keys.cpu().numpy(),
        "tsdf": v.tsdf.double().cpu().numpy(),
        "weight": v.weight.double().cpu().numpy(),
        "mesh": verts.double().cpu().numpy()[faces.long().cpu().numpy()],
    }


def gaps(program: dict, reference: dict) -> dict:
    """The largest absolute difference of each compared number; inf where
    the shapes differ (another node count, another set of allocated blocks,
    another triangle count) or where only one side ran the prior."""
    p, r = _host(program), _host(reference)
    out = {}
    for name in PRIOR:
        a, b = program.get("prior", {}).get(name), reference.get("prior", {}).get(name)
        if a is not None or b is not None:
            same = a is not None and b is not None and a.shape == b.shape
            out[name] = float((a.double() - b.double()).abs().max()) if same else np.inf
    for name in ("pose", "nodes_r", "nodes_t", "mesh"):
        out[name] = float(np.max(np.abs(p[name] - r[name]), initial=0.0)) if p[name].shape == r[name].shape else np.inf
    # the allocated blocks must be the same set; compare them in key order
    pk, rk = p["keys"], r["keys"]
    po, ro = np.argsort(pk, kind="stable"), np.argsort(rk, kind="stable")
    if pk.shape != rk.shape or not np.array_equal(pk[po], rk[ro]):
        out["tsdf"] = out["weight"] = np.inf
        return out
    pw, rw = p["weight"][po], r["weight"][ro]
    seen = (pw > 0) | (rw > 0)
    out["tsdf"] = float(np.max(np.abs(p["tsdf"][po] - r["tsdf"][ro])[seen], initial=0.0))
    out["weight"] = float(np.max(np.abs(pw - rw), initial=0.0))
    return out


def worst(rows: list[dict]) -> dict:
    return {name: max(row[name] for row in rows if name in row) for name in NAMES if any(name in r for r in rows)}


def reference_pipeline(overrides, intrinsics, device) -> FusionPipeline:
    return FusionPipeline(apply_overrides(Parameters(), list(overrides)), intrinsics, device=device)


def reference_chain(overrides, intrinsics, frames, stops, device, tf32: bool = False) -> dict:
    """The reference from the raw frames: initialize on the first, process
    the rest in order. Returns {i: snapshot after frames[i]} for each ``i``
    in ``stops``, with the prior's outputs of that frame."""
    pipe = reference_pipeline(overrides, intrinsics, device)
    out = {}
    with precision(tf32):
        pipe.initialize(*frames[0])
        for i, (depth, color) in enumerate(frames[1:], start=1):
            prior = {}
            with prior_outputs(DeformNet, prior):
                pipe.process_frame(depth, color)
            if i in stops:
                out[i] = {**snapshot(pipe), "prior": prior}
    return out


def reference_step(overrides, intrinsics, checkpoint_dir, frame, device, tf32: bool = False,
                   keyframe=None) -> dict:
    """The reference's next frame from the port's checkpoint, resumed as
    ``run_fusion`` resumes. ``keyframe`` (depth, color) is the prior's
    tracking source, with the identity as its node transforms (the first
    frame's, under ``FIRST_TO_CURRENT``)."""
    pipe = reference_pipeline(overrides, intrinsics, device)
    volume, field, _, mesh_state, camera_state = load_fusion_checkpoint(checkpoint_dir, pipe.device)
    pipe.volume, pipe.warp_field = volume, field
    pipe.restore_camera_state(camera_state)
    pipe._mesh_v_cap, pipe._mesh_t_cap = int(mesh_state["v_cap"]), int(mesh_state["t_cap"])
    pipe._count_host = tuple(mesh_state["count_host"])
    prior = {}
    with precision(tf32), prior_outputs(DeformNet, prior):
        pipe._refresh_canonical_mesh()
        if keyframe is not None:
            n = field.node_rotations.shape[0]
            pipe.keyframe_source = (pipe._frame(keyframe[0]), keyframe[1])
            pipe.keyframe_rotations = torch.eye(3, device=pipe.device).expand(n, 3, 3).contiguous()
            pipe.keyframe_translations = torch.zeros((n, 3), device=pipe.device)
        pipe.process_frame(*frame)
    return {**snapshot(pipe), "prior": prior}
