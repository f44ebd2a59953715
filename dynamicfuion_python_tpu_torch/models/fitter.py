"""Dense-depth Gauss-Newton / Levenberg-Marquardt mesh-to-image fitter (port
of ``dynamicfuion_python_tpu/models/fitter.py``, with its three data terms).

Per GN iteration: warp the canonical mesh by the hierarchical warp field,
expand its faces to pixel space (kernel B2), rasterize them (binned phase 1,
then kernel B1 per tile), form per-pixel point-to-plane residuals against
the observed point image, assemble 6x6-blocked normal equations (data term
on the diagonal; hierarchical ARAP giving the arrowhead wings and corner),
LM-damp, solve with the block-sparse arrowhead Cholesky, and apply the
per-node increments subject to the iteration mode and the valid-solve guard.

Fragment face ids are frozen per iteration; the residual's derivatives with
respect to the 18 warped vertex/normal scalars of its face come from
autograd of the scalarized pixel function (stage 1), the warp jacobians are
analytic (stage 2, per face), and the chain rule runs per covered pixel
(stage 3). The JAX package's one-hot MXU contractions are
``ops/segment_sum.py::segment_sum`` over N rows (the JAX overflow row N is
dropped): ``index_add_`` on the CPU, a one-hot product on the card, so the
card repeats bit for bit. The ``"fast"`` term runs the same
stages per pixel without compaction; the ``"autodiff"`` term differentiates
the whole per-pixel chain with ``torch.func`` (``vmap(jacrev)``).

With a process group (``group``, ``parallel/spmd.py``) each rank holds one
slab of the frame's pixel rows: every rank rasterizes the whole frame (B1
and B2 launch on every rank), computes the data term's rows for its own
pixels and adds them onto the sums of the ranks before it; the face term's
compaction cap stays the whole frame's, each rank keeping its covered
pixels whose rank in the frame is below it. The ARAP term and the solve run
on every rank and rank 0's update is broadcast.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import torch

from dynamicfuion_python_tpu_torch.models.warp_field import (
    HierarchicalGraphWarpField,
    NodeCoverageMethod,
)
from dynamicfuion_python_tpu_torch.ops import arap as arap_ops
from dynamicfuion_python_tpu_torch.ops.anchors import compute_anchors_euclidean
from dynamicfuion_python_tpu_torch.ops.compaction import compact_mask_indices
from dynamicfuion_python_tpu_torch.ops.linalg import (
    BlockSparseArrowheadMatrix,
    arrowhead_matvec,
    axis_angle_to_matrix,
    solve_block_diagonal_cholesky,
    solve_block_sparse_arrowhead,
)
from dynamicfuion_python_tpu_torch.ops.mesh_expand import expand_project_faces
from dynamicfuion_python_tpu_torch.ops.normals import mesh_vertex_normals
from dynamicfuion_python_tpu_torch.ops.rasterize import rasterize_binned
from dynamicfuion_python_tpu_torch.ops.segment_sum import segment_sum
from dynamicfuion_python_tpu_torch.ops.warp import blend_warp
from dynamicfuion_python_tpu_torch.parallel import spmd
from dynamicfuion_python_tpu_torch.utils import trace
from dynamicfuion_python_tpu_torch.utils.device import resolve_device


class IterationMode(enum.Enum):
    ALL = 0
    TRANSLATION_ONLY = 1
    ROTATION_ONLY = 2


@dataclasses.dataclass(frozen=True)
class FitterConfig:
    """Fitter settings; field meanings and defaults as in the JAX package."""

    max_iterations: int = 4
    iteration_modes: tuple = (IterationMode.ALL,)
    arap_term_weight: float = 200.0
    use_tukey_penalty: bool = False
    tukey_cutoff: float = 0.01
    use_huber_penalty: bool = False
    huber_constant: float = 0.0001
    levenberg_marquardt_factor: float = 0.001
    # stop once max |delta| <= this (0 always runs max_iterations)
    min_update_threshold: float = 1e-6
    # first coarse_iterations fit a coarse_factor-strided frame
    coarse_iterations: int = 0
    coarse_factor: int = 2
    max_depth: float = 10.0
    use_regularization: bool = True
    max_faces_per_bin: int = 256
    tile_size: int = 16
    # False forces the "autodiff" data term whatever data_term_impl says
    use_fast_data_term: bool = True
    # data term: "face" (face-major tables + covered-pixel compaction),
    # "fast" (pixel-major, same math) or "autodiff" (vmapped jacrev oracle)
    data_term_impl: str = "face"
    # covered-pixel compaction fraction of the face data term (0 disables)
    pixel_compaction_fraction: float = 0.6
    valid_solve_rotation_limit: float = 0.5
    valid_solve_translation_limit: float = 0.0
    valid_solve_residual_tolerance: float = 2.0
    valid_solve_escalated_residual_tolerance: float = 0.35
    # w j j^T instead of (w j)(w j)^T on the data-term diagonal blocks
    lump_data_hessian: bool = True

    def mode_for_iteration(self, i: int) -> IterationMode:
        return self.iteration_modes[i % len(self.iteration_modes)]


MAX_FACE_NODES = 12  # 3 vertices x 4 anchors


class FacePrecompute(NamedTuple):
    anchors: torch.Tensor  # int32[Nv, 4] virtual node ids per vertex
    weights: torch.Tensor  # f32[Nv, 4]
    face_nodes: torch.Tensor  # int32[F, 12] unique virtual node ids, -1 pad
    slot_of_vertex_anchor: torch.Tensor  # int64[F, 3, 4] -> slot in face_nodes


def precompute_face_associations(
    field: HierarchicalGraphWarpField, vertices: torch.Tensor, triangles: torch.Tensor
) -> FacePrecompute:
    """Vertex anchors (virtual ordering) + per-face merged node lists."""
    anchors, weights, _ = compute_anchors_euclidean(
        vertices,
        field.virtual_positions(),
        field.anchor_count,
        node_coverage_squared=field.virtual_coverage_weights_squared(),
        minimum_valid_anchor_count=field.minimum_valid_anchor_count,
        use_threshold=field.threshold_nodes_by_distance,
    )
    va = anchors[triangles.long()]  # [F, 3, A]
    f, three, a = va.shape
    flat = va.reshape(f, three * a)
    sorted_nodes = torch.sort(flat, dim=1).values
    heads = torch.ones_like(sorted_nodes, dtype=torch.bool)
    heads[:, 1:] = sorted_nodes[:, 1:] != sorted_nodes[:, :-1]
    heads = heads & (sorted_nodes >= 0)
    slot_sorted = torch.cumsum(heads.to(torch.int64), dim=1) - 1
    face_nodes = torch.full((f, MAX_FACE_NODES), -1, dtype=torch.int32, device=vertices.device)
    dest = torch.where(heads, slot_sorted, MAX_FACE_NODES - 1)
    face_nodes.scatter_reduce_(1, dest, torch.where(heads, sorted_nodes, -1), "amax")
    pos = torch.searchsorted(sorted_nodes.contiguous(), flat.contiguous())
    slot_lookup = torch.gather(slot_sorted, 1, pos.clamp(max=three * a - 1))
    slot_lookup = torch.where(flat >= 0, slot_lookup, -1)
    return FacePrecompute(anchors, weights, face_nodes, slot_lookup.reshape(f, three, a))


def _pixel_stage1(warped, px, py, ref_point, intrinsics):
    """Scalarized point-to-plane residual per pixel given the 18 warped
    quantities [w0.xyz, w1.xyz, w2.xyz, m0.xyz, m1.xyz, m2.xyz] of its face:
    projection, 2D barycentrics at the (integer) pixel center, perspective
    correction, interpolated point and normal."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cxi, cyi = intrinsics[0, 2], intrinsics[1, 2]
    wx = warped[:, 0:9:3]
    wy = warped[:, 1:9:3]
    wz = warped[:, 2:9:3]
    z = torch.maximum(wz, trace.upload(1e-6, wz.device, "fit.constants"))
    u = wx / z * fx + cxi
    v = wy / z * fy + cyi
    ax, ay = u[:, 0], v[:, 0]
    bx, by = u[:, 1], v[:, 1]
    cx2, cy2 = u[:, 2], v[:, 2]
    area = (cx2 - ax) * (by - ay) - (cy2 - ay) * (bx - ax)
    e0 = (px - bx) * (cy2 - by) - (py - by) * (cx2 - bx)
    e1 = (px - cx2) * (ay - cy2) - (py - cy2) * (ax - cx2)
    e2 = (px - ax) * (by - ay) - (py - ay) * (bx - ax)
    safe_area = torch.where(torch.abs(area) > 1e-12, area, 1e-12)
    bary2d = torch.stack([e0, e1, e2], dim=-1) / safe_area[:, None]
    pw = bary2d / z
    bary = pw / torch.maximum(torch.sum(pw, dim=-1), trace.upload(1e-12, pw.device, "fit.constants"))[:, None]
    depth = torch.sum(bary * wz, dim=-1)
    prx = (px - cxi) / fx * depth
    pry = (py - cyi) / fy * depth
    nx = torch.sum(bary * warped[:, 9:18:3], dim=-1)
    ny = torch.sum(bary * warped[:, 10:18:3], dim=-1)
    nz = torch.sum(bary * warped[:, 11:18:3], dim=-1)
    inv_norm = 1.0 / torch.maximum(
        torch.sqrt(nx * nx + ny * ny + nz * nz), trace.upload(1e-9, nx.device, "fit.constants")
    )
    return inv_norm * (
        nx * (prx - ref_point[:, 0]) + ny * (pry - ref_point[:, 1]) + nz * (depth - ref_point[:, 2])
    )


def _stage1_value_and_grad(warped, px, py, ref_point, intrinsics):
    """Residuals [P] and their gradients [P, 18]; each residual depends only
    on its own row, so one backward pass of the sum gives every row's
    gradient."""
    with torch.enable_grad():
        x = warped.detach().requires_grad_(True)
        res = _pixel_stage1(x, px, py, ref_point, intrinsics)
        (grad,) = torch.autograd.grad(res.sum(), x)
    return res.detach(), grad


def _pair_tables(
    tri, slot_map, face_nodes, pre_weights, pos_v, rot_v, trans_v, canonical_vertices, canonical_normals
):
    """Per-(vertex, anchor) warp quantities of the given face rows: the 18
    warped vertex / normal scalars [R, 18], the rotated offsets and normals
    [R, 36] (pair-major xyz), the anchor weights and face slots [R, 12]."""
    rows = tri.shape[0]
    tri_flat = tri.reshape(-1).long()
    slot_map = slot_map.reshape(rows, 12)
    va_w = pre_weights[tri_flat].reshape(rows, 12)
    wgt = torch.where(slot_map >= 0, va_w, 0.0)
    sid = slot_map.clamp(min=0)
    nid_flat = torch.gather(face_nodes, 1, sid).clamp(min=0).reshape(-1).long()
    r9 = rot_v.reshape(-1, 9)[nid_flat]
    g3 = pos_v[nid_flat]
    t3 = trans_v[nid_flat]
    vx = canonical_vertices[tri_flat].reshape(rows, 3, 3).repeat_interleave(4, dim=1).reshape(-1, 3)
    vn = canonical_normals[tri_flat].reshape(rows, 3, 3).repeat_interleave(4, dim=1).reshape(-1, 3)
    ox = vx[:, 0] - g3[:, 0]
    oy = vx[:, 1] - g3[:, 1]
    oz = vx[:, 2] - g3[:, 2]
    rox = r9[:, 0] * ox + r9[:, 1] * oy + r9[:, 2] * oz
    roy = r9[:, 3] * ox + r9[:, 4] * oy + r9[:, 5] * oz
    roz = r9[:, 6] * ox + r9[:, 7] * oy + r9[:, 8] * oz
    rnx = r9[:, 0] * vn[:, 0] + r9[:, 1] * vn[:, 1] + r9[:, 2] * vn[:, 2]
    rny = r9[:, 3] * vn[:, 0] + r9[:, 4] * vn[:, 1] + r9[:, 5] * vn[:, 2]
    rnz = r9[:, 6] * vn[:, 0] + r9[:, 7] * vn[:, 1] + r9[:, 8] * vn[:, 2]
    wf = wgt.reshape(-1)
    wv = torch.stack(
        [wf * (g3[:, 0] + rox + t3[:, 0]), wf * (g3[:, 1] + roy + t3[:, 1]), wf * (g3[:, 2] + roz + t3[:, 2])],
        dim=-1,
    ).reshape(rows, 3, 4, 3).sum(dim=2)
    wn = torch.stack([wf * rnx, wf * rny, wf * rnz], dim=-1).reshape(rows, 3, 4, 3).sum(dim=2)
    warped18 = torch.cat([wv.reshape(rows, 9), wn.reshape(rows, 9)], dim=1)
    rot_off = torch.stack([rox, roy, roz], dim=-1).reshape(rows, 36)
    rot_nrm = torch.stack([rnx, rny, rnz], dim=-1).reshape(rows, 36)
    return warped18, rot_off, rot_nrm, wgt, sid


def _chain_rule(grad18, ro, rn, wg, sid):
    """Stage 3: the 6-dof jacobian rows of each pixel's 12 face node slots,
    as 6 tensors [P, 12] (rotation xyz, translation xyz). The (vertex,
    anchor) pairs add into their slots one pair at a time (the JAX
    package's ``eye12[sid]`` one-hot adds): each step reads every pixel's
    slot of that pair, adds and writes it back, one element per pixel, so
    no two writes meet and no other slot is touched."""
    cap = grad18.shape[0]
    jac = torch.zeros((6, cap, 12), dtype=torch.float32, device=grad18.device)
    for i in range(3):
        gwx, gwy, gwz = grad18[:, 3 * i], grad18[:, 3 * i + 1], grad18[:, 3 * i + 2]
        gmx, gmy, gmz = grad18[:, 9 + 3 * i], grad18[:, 10 + 3 * i], grad18[:, 11 + 3 * i]
        for k in range(4):
            pair = i * 4 + k
            wgt = wg[:, pair]
            rx, ry, rz = ro[:, 3 * pair], ro[:, 3 * pair + 1], ro[:, 3 * pair + 2]
            sx, sy, sz = rn[:, 3 * pair], rn[:, 3 * pair + 1], rn[:, 3 * pair + 2]
            vals = torch.stack((
                -wgt * ((gwy * rz - gwz * ry) + (gmy * sz - gmz * sy)),
                -wgt * ((gwz * rx - gwx * rz) + (gmz * sx - gmx * sz)),
                -wgt * ((gwx * ry - gwy * rx) + (gmx * sy - gmy * sx)),
                wgt * gwx,
                wgt * gwy,
                wgt * gwz,
            ))
            slot = sid[None, :, pair : pair + 1].expand(6, cap, 1)
            jac.scatter_(2, slot, torch.gather(jac, 2, slot) + vals[..., None])
    return list(jac)


def _assemble_normal_equations(jac, residuals, ok, slot_nodes, config: FitterConfig, n: int, chain=None):
    """Robust weights, then the per-node 6x6 blocks and gradient rows of the
    data term: ``jac`` is 6 tensors [P, 12], ``slot_nodes`` int[P, 12] the
    node of each slot (-1 pad). ``chain`` (a row shard's) adds the rows
    after the ranks before this one and returns the frame's sums. Returns
    (h_data [N, 6, 6], g_data [N, 6], data_loss)."""
    residuals = torch.where(ok, residuals, 0.0)
    if config.use_tukey_penalty:
        c_t = config.tukey_cutoff
        tw = torch.where(torch.abs(residuals) < c_t, (1.0 - (residuals / c_t) ** 2) ** 2, 0.0)
    else:
        tw = torch.ones_like(residuals)
    weight = torch.where(ok, tw, 0.0)
    flat_nodes = slot_nodes.reshape(-1).long()
    flat_w = weight.repeat_interleave(12)
    flat_r = residuals.repeat_interleave(12)
    slot_ok = (flat_nodes >= 0) & (flat_w > 0)
    seg = torch.where(slot_ok, flat_nodes, n)  # segment n is dropped
    jflat = [jc.reshape(-1) for jc in jac]
    if config.lump_data_hessian:
        # |J_trans| of a (pixel, slot) is its blend weight: dividing one
        # power out lumps the block
        w_eff = torch.sqrt(jflat[3] ** 2 + jflat[4] ** 2 + jflat[5] ** 2)
        lump = 1.0 / torch.clamp(w_eff, min=1e-3)
    else:
        lump = torch.ones_like(jflat[0])
    # rows routed to the dropped segment n are zeroed first, as the JAX
    # package does before its one-hot sum: masked pixels may carry
    # non-finite stage-1 gradients
    scale = torch.where(slot_ok, lump * flat_w, 0.0)
    jsafe = [torch.where(slot_ok, jc, 0.0) for jc in jflat]
    gw = torch.where(slot_ok, flat_w * flat_r, 0.0)
    rows = [jsafe[a] * jsafe[b] * scale for a in range(6) for b in range(6)]
    rows += [-jc * gw for jc in jsafe]
    if chain is None:
        hg = segment_sum(torch.stack(rows, dim=-1), seg, n)
    else:
        hg = chain(seg, torch.stack(rows, dim=-1), n)
    h_data = hg[:, :36].reshape(n, 6, 6)
    g_data = hg[:, 36:]
    data_loss = 0.5 * torch.sum(weight * residuals**2)
    return h_data, g_data, data_loss


class RowShard(NamedTuple):
    """A rank's slab of the frame: rows [row0, row0 + slab height) of a
    frame ``height`` rows tall. ``budget``: how many of its covered pixels
    the face term may keep under the frame's compaction cap (None: all up
    to the cap). ``chain(seg, rows, num_segments)``: adds the slab's rows
    onto the sums of the ranks before it, in rank order, and returns the
    frame's sums (``parallel/spmd.py::chained_segment_sum``)."""

    row0: int
    height: int
    budget: torch.Tensor | None = None
    chain: object = None


def compaction_cap(total: int, fraction: float) -> int | None:
    """The face term's covered-pixel cap for a frame of ``total`` pixels:
    ``total * fraction`` rounded up to a multiple of 1024 (None: no
    compaction)."""
    if fraction and 0 < fraction < 1.0:
        return min(total, ((int(total * fraction) + 1023) // 1024) * 1024)
    return None


def _pixel_grid(h: int, w: int, dev, row0: int = 0):
    lin = torch.arange(h * w, device=dev)
    return (lin % w).to(torch.float32), (lin // w + row0).to(torch.float32)


def _data_term_face(
    pos_v, rot_v, trans_v, canonical_vertices, canonical_normals, canonical_triangles,
    pre: FacePrecompute, frag_faces, reference_points, reference_mask, intrinsics,
    config: FitterConfig, num_nodes: int, shard: RowShard | None = None,
):
    """Face-major data term: per-(vertex, anchor) warp quantities once per
    face, per-pixel stages on the compacted covered-pixel set. Returns
    (h_data f32[N, 6, 6], g_data f32[N, 6], data_loss). With ``shard`` the
    images are that slab's rows."""
    dev = canonical_vertices.device
    h, w = reference_mask.shape
    warped18_f, rot_off_f, rot_nrm_f, wgt_f, sid_f = _pair_tables(
        canonical_triangles, pre.slot_of_vertex_anchor, pre.face_nodes, pre.weights,
        pos_v, rot_v, trans_v, canonical_vertices, canonical_normals,
    )

    # ---- covered-pixel compaction (the cap is the whole frame's)
    row0 = shard.row0 if shard is not None else 0
    pix_face = frag_faces.reshape(-1).long()
    pix_ok = (pix_face >= 0) & reference_mask.reshape(-1)
    cap = compaction_cap((shard.height if shard is not None else h) * w, config.pixel_compaction_fraction)
    if cap is not None:
        size = min(cap, h * w)
        idx, n_ok = compact_mask_indices(pix_ok, size, fill_value=0)
        if shard is not None and shard.budget is not None:
            n_ok = torch.minimum(n_ok, shard.budget)
        ok = torch.arange(size, device=dev) < n_ok
        pface = torch.where(ok, pix_face[idx], 0)
        ref_pts = reference_points.reshape(-1, 3)[idx]
        px = (idx % w).to(torch.float32)
        py = (idx // w + row0).to(torch.float32)
    else:
        ok = pix_ok
        pface = pix_face
        ref_pts = reference_points.reshape(-1, 3)
        px, py = _pixel_grid(h, w, dev, row0)
    safe_face = pface.clamp(min=0)
    residuals, grad18 = _stage1_value_and_grad(warped18_f[safe_face], px, py, ref_pts, intrinsics)
    jac = _chain_rule(grad18, rot_off_f[safe_face], rot_nrm_f[safe_face], wgt_f[safe_face], sid_f[safe_face])
    return _assemble_normal_equations(
        jac, residuals, ok, pre.face_nodes[safe_face], config, num_nodes, shard.chain if shard is not None else None
    )


def _data_term_fast(
    pos_v, rot_v, trans_v, canonical_vertices, canonical_normals, canonical_triangles,
    pre: FacePrecompute, frag_faces, reference_points, reference_mask, intrinsics,
    config: FitterConfig, num_nodes: int, shard: RowShard | None = None,
):
    """Pixel-major data term: the face term's math with the warp quantities
    computed per pixel from its fragment face and no compaction. Returns
    (h_data f32[N, 6, 6], g_data f32[N, 6], data_loss)."""
    h, w = reference_mask.shape
    pix_face = frag_faces.reshape(-1).long()
    ok = (pix_face >= 0) & reference_mask.reshape(-1)
    safe_face = pix_face.clamp(min=0)
    face_nodes = pre.face_nodes[safe_face]
    warped18, ro, rn, wg, sid = _pair_tables(
        canonical_triangles[safe_face], pre.slot_of_vertex_anchor[safe_face], face_nodes, pre.weights,
        pos_v, rot_v, trans_v, canonical_vertices, canonical_normals,
    )
    px, py = _pixel_grid(h, w, canonical_vertices.device, shard.row0 if shard is not None else 0)
    residuals, grad18 = _stage1_value_and_grad(warped18, px, py, reference_points.reshape(-1, 3), intrinsics)
    jac = _chain_rule(grad18, ro, rn, wg, sid)
    return _assemble_normal_equations(
        jac, residuals, ok, face_nodes, config, num_nodes, shard.chain if shard is not None else None
    )


def _pixel_residual(
    delta, px, py, vert_pos, vert_normal, vert_anchor_slots, vert_anchor_weights,
    node_pos, node_rot, node_trans, ref_point, intrinsics,
):
    """Point-to-plane residual at one pixel as a function of the 6-dof
    deltas [12, 6] of its face's node slots: node deltas -> warped face
    vertices and normals -> projection -> 2D barycentrics at the pixel
    center -> perspective-correct interpolation -> dot(n, p_rast - p_ref).
    Returns the residual twice (value and ``jacrev``'s aux)."""
    d_rot = axis_angle_to_matrix(delta[:, :3])
    rot = torch.einsum("nab,nbc->nac", d_rot, node_rot)
    trans = node_trans + delta[:, 3:]
    slots = vert_anchor_slots.clamp(min=0)
    w = torch.where(vert_anchor_slots >= 0, vert_anchor_weights, 0.0)
    g = node_pos[slots]
    rr = rot[slots]
    tt = trans[slots]
    offset = vert_pos[:, None, :] - g
    rotated = torch.einsum("vkab,vkb->vka", rr, offset)
    warped_v = torch.einsum("vk,vka->va", w, g + rotated + tt)
    warped_n = torch.einsum("vk,vka->va", w, torch.einsum("vkab,vb->vka", rr, vert_normal))

    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    z = torch.clamp(warped_v[:, 2], min=1e-6)
    u = warped_v[:, 0] / z * fx + cx
    v = warped_v[:, 1] / z * fy + cy
    ax, ay = u[0], v[0]
    bx, by = u[1], v[1]
    cx2, cy2 = u[2], v[2]
    area = (cx2 - ax) * (by - ay) - (cy2 - ay) * (bx - ax)
    e0 = (px - bx) * (cy2 - by) - (py - by) * (cx2 - bx)
    e1 = (px - cx2) * (ay - cy2) - (py - cy2) * (ax - cx2)
    e2 = (px - ax) * (by - ay) - (py - ay) * (bx - ax)
    safe_area = torch.where(torch.abs(area) > 1e-12, area, 1e-12)
    bary2d = torch.stack([e0, e1, e2]) / safe_area
    pw = bary2d / z
    bary = pw / torch.clamp(torch.sum(pw), min=1e-12)
    depth = torch.sum(bary * warped_v[:, 2])
    p_rast = torch.stack([(px - cx) / fx * depth, (py - cy) / fy * depth, depth])
    n_rast = torch.einsum("v,va->a", bary, warped_n)
    n_rast = n_rast / torch.clamp(torch.linalg.norm(n_rast), min=1e-9)
    r = torch.sum(n_rast * (p_rast - ref_point))
    return r, r


_residual_and_jacobian = torch.func.vmap(
    torch.func.jacrev(_pixel_residual, argnums=0, has_aux=True),
    in_dims=(None, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None),
)


def _data_term_autodiff(
    pos_v, rot_v, trans_v, canonical_vertices, canonical_normals, canonical_triangles,
    pre: FacePrecompute, frag_faces, reference_points, reference_mask, intrinsics,
    config: FitterConfig, num_nodes: int, shard: RowShard | None = None,
):
    """The data term from per-pixel jacobians of the whole residual chain
    (``vmap(jacrev)``): the oracle the analytic terms are held to. Returns
    (h_data f32[N, 6, 6], g_data f32[N, 6], data_loss)."""
    dev = canonical_vertices.device
    h, w = reference_mask.shape
    pix_face = frag_faces.reshape(-1).long()
    ok = (pix_face >= 0) & reference_mask.reshape(-1)
    safe_face = pix_face.clamp(min=0)
    tri = canonical_triangles[safe_face].long()
    face_nodes = pre.face_nodes[safe_face]
    safe_nodes = face_nodes.clamp(min=0).long()
    px, py = _pixel_grid(h, w, dev, shard.row0 if shard is not None else 0)
    zero_delta = torch.zeros((MAX_FACE_NODES, 6), dtype=torch.float32, device=dev)
    jac, residuals = _residual_and_jacobian(
        zero_delta, px, py, canonical_vertices[tri], canonical_normals[tri],
        pre.slot_of_vertex_anchor[safe_face].long(), pre.weights[tri],
        pos_v[safe_nodes], rot_v[safe_nodes], trans_v[safe_nodes],
        reference_points.reshape(-1, 3), intrinsics,
    )  # jac [P, 12, 6], residuals [P]
    return _assemble_normal_equations(
        [jac[..., c] for c in range(6)], residuals, ok, face_nodes, config, num_nodes,
        shard.chain if shard is not None else None,
    )


_DATA_TERMS = {"face": _data_term_face, "fast": _data_term_fast, "autodiff": _data_term_autodiff}


def data_term_impl(config: FitterConfig) -> str:
    """The data term a configuration selects; raises for an unknown name."""
    impl = config.data_term_impl if config.use_fast_data_term else "autodiff"
    if impl not in _DATA_TERMS:
        raise ValueError(f"unknown data_term_impl {impl!r}; expected one of {sorted(_DATA_TERMS)}")
    return impl


def _max_wing_degree(field: HierarchicalGraphWarpField) -> int:
    return max(1, min(4, field.layer_node_counts[1] if len(field.layer_node_counts) > 1 else 1))


def data_normal_equations(
    pos_v, rot_v, trans_v, canonical_vertices, canonical_normals, canonical_triangles,
    pre: FacePrecompute, frame_faces, reference_points, reference_mask, intrinsics,
    config: FitterConfig, num_nodes: int, group=None,
):
    """The configured data term's normal equations over the frame's
    rasterized face ids ``frame_faces`` [H, W]. With ``group`` the
    reference points and mask are this rank's row slab: the rank assembles
    its rows, keeping those of its covered pixels whose rank in the whole
    frame is below the frame's compaction cap (one ``all_reduce`` of the
    ranks' covered-pixel counts gives the prefix). H and g add each rank's
    rows onto the running sums of the ranks before it (one ``broadcast``
    per rank), in one process's order: on the CPU they equal its sums bit
    for bit. An ``all_reduce`` sums the loss. Returns (h_data f32[N, 6, 6],
    g_data f32[N, 6], data_loss, covered pixels of the frame, the cap or
    None)."""
    impl = data_term_impl(config)
    dev = canonical_vertices.device
    slab_h, w = reference_mask.shape
    h, row0 = slab_h, 0
    if group is not None:
        world, rank = spmd.group_size(group), spmd.group_rank(group)
        h, row0 = slab_h * world, rank * slab_h
    frag_faces = frame_faces[row0 : row0 + slab_h]
    cap = compaction_cap(h * w, config.pixel_compaction_fraction) if impl == "face" else None
    n_covered = torch.sum((frag_faces.reshape(-1) >= 0) & reference_mask.reshape(-1))
    kwargs = {}
    if group is not None:
        counts = torch.zeros(world, dtype=torch.float64, device=dev)
        counts[rank] = n_covered
        (counts,) = spmd.all_reduce_sum([counts], group)
        n_covered = torch.sum(counts)
        budget = None if cap is None else torch.clamp(cap - torch.sum(counts[:rank]), min=0).to(torch.int64)
        kwargs["shard"] = RowShard(
            row0, h, budget, lambda seg, rows, n: spmd.chained_segment_sum(rows, seg, n, group)
        )
    h_data, g_data, data_loss = _DATA_TERMS[impl](
        pos_v, rot_v, trans_v, canonical_vertices, canonical_normals, canonical_triangles,
        pre, frag_faces, reference_points, reference_mask, intrinsics, config, num_nodes, **kwargs,
    )
    if group is not None:
        (data_loss,) = spmd.all_reduce_sum([data_loss], group)
    return h_data, g_data, data_loss, n_covered, cap


class StepResult(NamedTuple):
    field: HierarchicalGraphWarpField
    data_loss: torch.Tensor
    arap_loss: torch.Tensor
    valid_solve: torch.Tensor
    max_update: torch.Tensor
    cap_kept: torch.Tensor
    overflow: dict
    escalations: torch.Tensor
    corner_damping: torch.Tensor


def gauss_newton_step(
    field: HierarchicalGraphWarpField,
    canonical_vertices, canonical_triangles, canonical_normals,
    pre: FacePrecompute, reference_points, reference_mask, intrinsics,
    config: FitterConfig, mode: IterationMode, max_deg: int, group=None,
) -> StepResult:
    """One GN/LM iteration (see the module docstring). With ``group`` the
    reference points and mask are this rank's slab of the frame's rows
    (rank r of W holds rows [r h, (r + 1) h) of an h W-row frame)."""
    trace.count("fit.gn_iterations")
    dev = canonical_vertices.device
    h, w = reference_mask.shape
    if group is not None:
        h *= spmd.group_size(group)
    n = field.num_nodes
    n0 = field.arrow_base
    nc = n - n0
    pos_v = field.virtual_positions()
    rot_v = field.virtual_rotations()
    trans_v = field.virtual_translations()

    # ---- association pass: warp, expand (B2), bin + rasterize (B1)
    with trace.span("fit.raster"):
        warped_vertices = blend_warp(canonical_vertices, pos_v, rot_v, trans_v, pre.anchors, pre.weights)
        face_verts_pix, valid_faces, _ = expand_project_faces(
            warped_vertices, canonical_triangles, intrinsics, near=1e-3, far=config.max_depth
        )
        frag, overflow = rasterize_binned(
            face_verts_pix, valid_faces, (h, w),
            faces_per_pixel=1, perspective_correct=True, cull_back_faces=False,
            tile_size=config.tile_size, max_faces_per_bin=config.max_faces_per_bin,
            return_overflow=True,
        )
    with trace.span("fit.data_term"):
        h_data, g_data, data_loss, n_covered, cap = data_normal_equations(
            pos_v, rot_v, trans_v, canonical_vertices, canonical_normals, canonical_triangles,
            pre, frag.face_indices[..., 0], reference_points, reference_mask, intrinsics, config, n, group,
        )

    # ---- ARAP term
    with trace.span("fit.arap"):
        if config.use_regularization and field.edges.shape[0] > 0:
            if field.coverage_method == NodeCoverageMethod.FIXED:
                ew = arap_ops.edge_weights_fixed(field.edge_layer_indices, field.layer_decimation_radii)
            else:
                ew = arap_ops.edge_weights_variable(field.edges, field.virtual_coverage_weights_squared())
            term = arap_ops.compute_arap_term(
                field.edges, pos_v, rot_v, trans_v, ew, config.arap_term_weight,
                config.huber_constant if config.use_huber_penalty else None,
            )
            stem_diag, wing, wing_cols, corner, g_arap = arap_ops.assemble_arap_normal_equations(
                term, field.edges, n, n0, max_deg
            )
            arap_loss = 0.5 * torch.sum(term.residuals**2)
        else:
            stem_diag = torch.zeros((n0, 6, 6), device=dev)
            wing = torch.zeros((n0, max_deg, 6, 6), device=dev)
            wing_cols = torch.full((n0, max_deg), -1, dtype=torch.int32, device=dev)
            corner = torch.zeros((max(nc, 1) * 6, max(nc, 1) * 6), device=dev)
            g_arap = torch.zeros((n * 6,), device=dev)
            arap_loss = torch.zeros((), device=dev)

    # ---- combine, damp, mask by iteration mode; solve
    with trace.span("fit.solve"):
        gradient = g_data.reshape(-1) + g_arap
        stem = h_data[:n0] + stem_diag
        corner_total = corner
        if nc > 0:
            ci = torch.arange(nc, device=dev)
            corner_total = corner_total.reshape(nc, 6, nc, 6).clone()
            corner_total[ci, :, ci, :] += h_data[n0:]
            corner_total = corner_total.reshape(nc * 6, nc * 6)
        if mode == IterationMode.TRANSLATION_ONLY:
            dof_mask = trace.upload([0.0, 0.0, 0.0, 1.0, 1.0, 1.0], dev, "fit.constants")
        elif mode == IterationMode.ROTATION_ONLY:
            dof_mask = trace.upload([1.0, 1.0, 1.0, 0.0, 0.0, 0.0], dev, "fit.constants")
        else:
            dof_mask = torch.ones(6, device=dev)
        mask66 = dof_mask[:, None] * dof_mask[None, :]
        lam = config.levenberg_marquardt_factor
        # disabled dofs: masked out, identity on their diagonal (blocks stay SPD,
        # their solution is exactly zero)
        eye6 = torch.eye(6, device=dev)
        stem = stem * mask66 + torch.diag(1.0 - dof_mask)[None] + lam * eye6
        wing = wing * mask66[None, None]
        if nc > 0:
            corner_mask = dof_mask.repeat(nc)
            corner_total = corner_total * (corner_mask[:, None] * corner_mask[None, :])
            corner_total = corner_total + torch.diag((1.0 - dof_mask).repeat(nc))
            corner_total = corner_total + lam * torch.eye(nc * 6, device=dev)
        gradient = gradient * dof_mask.repeat(n)

        if nc > 0:
            matrix = BlockSparseArrowheadMatrix(stem, wing, wing_cols, corner_total)
            solution, escalations, mu = solve_block_sparse_arrowhead(matrix, gradient)
            # residual against the system actually factorized (H + mu on the
            # corner diagonal)
            h_sol = arrowhead_matvec(matrix, solution)
            h_sol = torch.cat([h_sol[: n0 * 6], h_sol[n0 * 6 :] + mu * solution[n0 * 6 :]])
        else:
            solution = solve_block_diagonal_cholesky(stem, gradient.reshape(n, 6)).reshape(-1)
            escalations = torch.zeros((), dtype=torch.int32, device=dev)
            mu = torch.zeros((), device=dev)
            h_sol = torch.einsum("nab,nb->na", stem, solution.reshape(n, 6)).reshape(-1)
        delta = solution.reshape(n, 6) * dof_mask[None, :]

    # ---- valid-solve guard: physical limits + solve-residual conditioning;
    # an invalid iteration applies zero delta
    with trace.span("fit.guard"):
        trans_limit = config.valid_solve_translation_limit or max(4.0 * field.node_coverage, 0.4)
        g_norm = torch.linalg.norm(gradient)
        rel_residual = torch.linalg.norm(h_sol - gradient) / torch.clamp(g_norm, min=1e-20)
        residual_tol = torch.where(
            escalations > 0,
            trace.upload(config.valid_solve_escalated_residual_tolerance, dev, "fit.constants"),
            trace.upload(config.valid_solve_residual_tolerance, dev, "fit.constants"),
        )
        valid_solve = (
            torch.all(torch.isfinite(delta))
            & (torch.amax(torch.abs(delta[:, :3])) < config.valid_solve_rotation_limit)
            & (torch.amax(torch.abs(delta[:, 3:])) < trans_limit)
            & ((rel_residual < residual_tol) | (g_norm < 1e-12))
        )
        delta = torch.where(valid_solve, delta, 0.0)
        field = field.rotate_nodes_virtual(delta[:, :3]).translate_nodes_virtual(delta[:, 3:])
        max_update = torch.amax(torch.abs(delta))
        if group is not None:
            # every rank continues from rank 0's update (the card's atomics may
            # have summed the ARAP blocks in another order on each rank)
            rot, trans, max_update, valid_solve = spmd.replicate(
                [field.node_rotations, field.node_translations, max_update, valid_solve], group
            )
            field = field.replace(node_rotations=rot, node_translations=trans)

    # fraction of covered pixels the compaction cap kept (1.0 = none dropped)
    if cap is not None:
        cap_kept = (torch.clamp(n_covered, max=cap).to(torch.float32)
                    / torch.clamp(n_covered, min=1).to(torch.float32))
    else:
        cap_kept = torch.ones((), device=dev)
    return StepResult(
        field, data_loss, arap_loss, valid_solve, max_update, cap_kept, overflow, escalations, mu
    )


def fit_to_image(
    field: HierarchicalGraphWarpField,
    canonical_vertices,
    canonical_triangles,
    reference_points,
    reference_mask,
    intrinsics,
    config: FitterConfig = FitterConfig(),
    device: str | torch.device | None = None,
    group=None,
) -> tuple[HierarchicalGraphWarpField, dict]:
    """Run the GN/LM loop on ``device`` (the CUDA card unless the caller
    passes ``device="cpu"``); returns the updated field + diagnostics. With
    ``group`` the reference points and mask are this rank's row slab of the
    frame (see :func:`gauss_newton_step`).

    The loop stops early once an iteration's largest update is at most
    ``min_update_threshold`` (single-mode schedules); the diagnostics of
    iterations that did not run repeat the last one that did.
    """
    data_term_impl(config)  # refuse an unknown data term before any work
    dev = resolve_device(device)
    field = field.to(dev)
    verts = torch.as_tensor(canonical_vertices, dtype=torch.float32, device=dev)
    tris = torch.as_tensor(canonical_triangles, device=dev).to(torch.int32).contiguous()
    ref_points = torch.as_tensor(reference_points, dtype=torch.float32, device=dev)
    ref_mask = torch.as_tensor(reference_mask, device=dev).to(torch.bool)
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=dev).contiguous()
    max_deg = _max_wing_degree(field)

    with torch.no_grad():
        with trace.span("fit.setup"):
            pre = precompute_face_associations(field, verts, tris)
            normals = mesh_vertex_normals(verts, tris)
        runs: list[list] = []
        for iteration in range(config.max_iterations):
            mode = config.mode_for_iteration(iteration)
            if runs and runs[-1][0] == mode:
                runs[-1][1] += 1
            else:
                runs.append([mode, 1])
        f = max(1, config.coarse_factor)
        cc = 0
        if config.coarse_iterations > 0 and f > 1 and len(runs) == 1:
            cc = min(config.coarse_iterations, config.max_iterations)
        full_views = (ref_points, ref_mask, intr)
        if cc and group is not None and ref_mask.shape[0] % f:
            raise ValueError(f"a {ref_mask.shape[0]}-row slab does not stride by the coarse factor {f}")
        if cc:
            coarse_intr = intr.clone()
            coarse_intr[:2, :] = coarse_intr[:2, :] * (1.0 / f)
            coarse_views = (
                ref_points[::f, ::f].contiguous(), ref_mask[::f, ::f].contiguous(), coarse_intr
            )
            mode = runs[0][0]
            segments = [(mode, cc, coarse_views)]
            if config.max_iterations - cc > 0:
                segments.append((mode, config.max_iterations - cc, full_views))
        else:
            segments = [(mode, count, full_views) for mode, count in runs]
        use_while = len(runs) == 1 and config.min_update_threshold > 0

        steps: list[StepResult] = []
        for mode, count, (rp, rm, intr_v) in segments:
            done = []
            for _ in range(count):
                with trace.span("fit.iteration"):
                    out = gauss_newton_step(
                        field, verts, tris, normals, pre, rp, rm, intr_v, config, mode, max_deg, group=group
                    )
                    field = out.field
                    done.append(out)
                    # convergence exit (one host read per iteration)
                    if use_while and trace.host_read(out.max_update, "fit.exit") <= config.min_update_threshold:
                        trace.count("fit.early_exits")
                        break
            steps.extend(done + [done[-1]] * (count - len(done)))

    diagnostics = {
        "data_loss": [s.data_loss for s in steps],
        "arap_loss": [s.arap_loss for s in steps],
        "node_translations_per_iteration": torch.stack([s.field.node_translations for s in steps]),
        "valid_solve": torch.stack([s.valid_solve for s in steps]),
        "pixel_cap_kept_fraction": [s.cap_kept for s in steps],
        "dropped_large_faces": torch.stack([s.overflow["dropped_large_faces"] for s in steps]),
        "dropped_bin_entries": torch.stack([s.overflow["dropped_bin_entries"] for s in steps]),
        "damping_escalations": torch.stack([s.escalations for s in steps]),
        "corner_damping": torch.stack([s.corner_damping for s in steps]),
    }
    return field, diagnostics
