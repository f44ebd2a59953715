"""Seeded synthetic inputs of the fitter's face data term, small enough for
the CPU and with the edge cases its card kernel must repeat: anchors
dropped (faces with fewer than 12 distinct nodes), near-zero and zero
pixel-space area, vertices at and below the 1e-6 depth clamp, and a face 0
whose corners are not finite (only the masked rows of the compacted term
read it). Imports nothing of JAX."""

import torch

from dynamicfuion_python_tpu_torch.models.fitter import MAX_FACE_NODES, FacePrecompute
from dynamicfuion_python_tpu_torch.ops.linalg import axis_angle_to_matrix

INTRINSICS = [[60.0, 0.0, 48.0], [0.0, 60.0, 32.0], [0.0, 0.0, 1.0]]


def face_tables(anchors: torch.Tensor, triangles: torch.Tensor):
    """Each face's distinct nodes, ascending, -1 padded [F, 12], and the slot
    of each (vertex, anchor) pair [F, 3, 4] (-1 for a dropped anchor), as
    ``precompute_face_associations`` lays them out."""
    f = triangles.shape[0]
    nodes = torch.full((f, MAX_FACE_NODES), -1, dtype=torch.int32)
    slots = torch.full((f, 3, 4), -1, dtype=torch.int64)
    for i, tri in enumerate(triangles.tolist()):
        va = anchors[tri].tolist()
        distinct = sorted({a for row in va for a in row if a >= 0})
        nodes[i, : len(distinct)] = torch.tensor(distinct, dtype=torch.int32)
        for v, row in enumerate(va):
            for k, a in enumerate(row):
                if a >= 0:
                    slots[i, v, k] = distinct.index(a)
    return nodes, slots


def synthetic_face_inputs(seed: int = 0, h: int = 64, w: int = 96, n_nodes: int = 40, n_verts: int = 64,
                          n_faces: int = 80):
    """The face term's arguments up to its configuration (a tuple in the
    order of ``fitter._data_term_face``'s first 11), on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    pos = torch.randn((n_nodes, 3), generator=gen) * 0.1 + torch.tensor([0.0, 0.0, 1.2])
    rot = axis_angle_to_matrix(torch.randn((n_nodes, 3), generator=gen) * 0.1)
    trans = torch.randn((n_nodes, 3), generator=gen) * 0.01
    verts = torch.randn((n_verts, 3), generator=gen) * torch.tensor([0.15, 0.1, 0.05]) + torch.tensor([0.0, 0.0, 1.2])
    normals = torch.nn.functional.normalize(torch.randn((n_verts, 3), generator=gen), dim=1)
    anchors = torch.randint(0, n_nodes - 1, (n_verts, 4), generator=gen, dtype=torch.int32)
    anchors[::5, 3] = -1
    anchors[::7, 2:] = -1
    weights = torch.where(anchors >= 0, torch.rand((n_verts, 4), generator=gen) + 0.1, 0.0)
    tris = torch.randint(0, n_verts - 9, (n_faces, 3), generator=gen, dtype=torch.int32)
    # node n_nodes - 1 is the identity warp at the origin: a vertex anchored
    # to it alone keeps its coordinates exactly
    last = n_nodes - 1
    pos[last], rot[last], trans[last] = 0.0, torch.eye(3), 0.0
    exact = list(range(n_verts - 9, n_verts - 3))
    anchors[exact] = torch.tensor([last, -1, -1, -1], dtype=torch.int32)
    weights[exact] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    # face 1: on the depth clamp (z = 1e-6 exactly, a tie); face 2: below it
    verts[exact[:3], 2] = 1e-6
    verts[exact[3:], 2] = torch.tensor([0.0, -1e-3, 1e-7])
    tris[1] = torch.tensor(exact[:3], dtype=torch.int32)
    tris[2] = torch.tensor(exact[3:], dtype=torch.int32)
    # face 3: a repeated vertex (zero area); face 4: near-collinear corners
    tris[3, 2] = tris[3, 0]
    a, b = verts[tris[4, 0].long()], verts[tris[4, 1].long()]
    verts[tris[4, 2].long()] = a + (b - a) * 0.37 + torch.tensor([0.0, 1e-7, 0.0])
    # face 0 reads the last three vertices, which are not finite
    tris[0] = torch.tensor([n_verts - 3, n_verts - 2, n_verts - 1], dtype=torch.int32)
    verts[n_verts - 3 :] = torch.tensor([[float("nan"), 0.0, 1.0], [0.0, float("inf"), 1.0], [0.1, 0.1, 0.0]])
    face_nodes, slots = face_tables(anchors, tris)
    # every face but 0 in a pixel, a fifth of the pixels empty, and the
    # clamp and area faces in many
    frag = torch.randint(1, n_faces, (h, w), generator=gen, dtype=torch.int32)
    frag[torch.rand((h, w), generator=gen) < 0.2] = -1
    special = torch.rand((h, w), generator=gen) < 0.1
    frag[special] = torch.randint(1, 5, (int(special.sum()),), generator=gen, dtype=torch.int32)
    ref = torch.randn((h, w, 3), generator=gen) * 0.05 + torch.tensor([0.0, 0.0, 1.2])
    mask = torch.rand((h, w), generator=gen) > 0.15
    ref[~mask] = float("nan")
    pre = FacePrecompute(anchors, weights, face_nodes, slots)
    return pos, rot, trans, verts, normals, tris, pre, frag, ref, mask, torch.tensor(INTRINSICS)
