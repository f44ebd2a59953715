"""The face data term's card kernel seen from the CPU: its byte count (the
kernel's bound) against a count made pixel by pixel, its wrapper's checks,
and the rule that the term on CPU tensors runs the plain functions and
never reaches the kernel's library. The kernel itself is held to the plain
functions on the card (tests/test_torch_kernels_gpu.py)."""

import pytest
import torch

from _face_rows_inputs import synthetic_face_inputs
from dynamicfuion_python_tpu_torch.models import fitter
from dynamicfuion_python_tpu_torch.ops import face_data_rows as fr
from dynamicfuion_python_tpu_torch.ops import native
from dynamicfuion_python_tpu_torch.utils import trace


def _counted(tris, face_nodes, slots, frag, mask, idx, n_ok) -> dict:
    """What the kernel reads and writes, pixel by pixel."""
    h, w = frag.shape
    flat = frag.reshape(-1).tolist()
    tris, face_nodes, slots = tris.tolist(), face_nodes.tolist(), slots.tolist()
    faces, verts, nodes, kept = set(), set(), set(), 0
    pixels = idx.tolist() if idx is not None else range(h * w)
    for p, q in enumerate(pixels):
        if idx is not None:
            ok = p < int(n_ok)
            kept += ok
            f = flat[q] if ok else 0
        else:
            f = max(flat[p], 0)
        faces.add(f)
        for i in range(3):
            verts.add(tris[f][i])
            for k in range(4):
                nodes.add(max(face_nodes[f][max(slots[f][i][k], 0)], 0))
    p = len(pixels)
    per_pixel = 8 + 12 if idx is not None else 4 + 1 + 12
    fixed = 36 + (8 + kept * 4 if idx is not None else 0)
    written = p * (12 * 42 * 4 + 12 * 8 + 4 + 4)
    return {"pixels": p, "faces": len(faces), "vertices": len(verts), "nodes": len(nodes),
            "bytes": fixed + p * per_pixel + len(faces) * 156 + len(verts) * 40 + len(nodes) * 60 + written}


@pytest.mark.parametrize("frac", [0.6, 0.1, 0.0])
def test_face_rows_work_counts_what_the_kernel_reads(frac):
    args = synthetic_face_inputs(1, h=16, w=24, n_faces=40)
    _, _, _, _, _, tris, pre, frag, _, mask, _ = args
    idx, n_ok = fitter._face_row_inputs(*args, fitter.FitterConfig(pixel_compaction_fraction=frac), 40)[14:16]
    want = _counted(tris, pre.face_nodes, pre.slot_of_vertex_anchor, frag, mask, idx, n_ok)
    assert fr.face_data_rows_work(tris, pre.face_nodes, pre.slot_of_vertex_anchor, frag, mask, idx, n_ok) == want
    assert want["nodes"] > 10 and want["faces"] > 10


def test_face_rows_cuda_refuses_cpu_tensors():
    pos, rot, trans, verts, normals, tris, pre, frag, ref, mask, intr = synthetic_face_inputs(2, h=8, w=8)
    with pytest.raises(ValueError, match="card tensors"):
        fr.face_data_rows_cuda(pos, rot, trans, verts, normals, tris, pre.weights, pre.face_nodes,
                               pre.slot_of_vertex_anchor, frag, ref, mask, intr, pos.shape[0])


def test_face_term_on_the_cpu_runs_the_plain_functions(monkeypatch):
    """CPU tensors never reach the kernel's library: the rows come from
    ``_face_rows_plain`` (NaN for NaN), the launch counter stays at 0."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU face term reached ops/native.py")

    monkeypatch.setattr(native, "entry_point", refuse)
    calls = []
    plain = fitter._face_rows_plain
    monkeypatch.setattr(fitter, "_face_rows_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    trace.reset()
    args = synthetic_face_inputs(3, h=16, w=24)
    for frac in (0.6, 0.0):
        h, g, loss = fitter._data_term_face(*args, fitter.FitterConfig(pixel_compaction_fraction=frac), 40)
        assert h.shape == (40, 6, 6) and g.shape == (40, 6) and loss.dim() == 0
    assert len(calls) == 2 and trace.counter("face_rows.launches") == 0
