"""Hierarchical ARAP (as-rigid-as-possible) regularization term (port of
``dynamicfuion_python_tpu/ops/arap.py``).

Per hierarchy edge e = (i, j) (i finer, j coarser, virtual indices):

    r_e = lam * w_e * [ (g_i + t_i) - (g_j + t_j) - R_i (g_i - g_j) ]

    d r_e / d rot_i = lam*w_e * skew(R_i (g_i - g_j)),
    d r_e / d t_i = lam*w_e * I,  d r_e / d t_j = -lam*w_e * I.

The JAX package's one-hot contractions become ``ops/segment_sum.py``
sums (``index_add_`` on the CPU, a fixed-order one-hot product on the
card), rows with an out-of-range destination dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamicfuion_python_tpu_torch.ops.linalg.rodrigues import skew
from dynamicfuion_python_tpu_torch.ops.segment_sum import segment_sum


class ArapTerm(NamedTuple):
    residuals: torch.Tensor  # f32[E, 3]
    rotation_jacobian_i: torch.Tensor  # f32[E, 3, 3]
    translation_scale: torch.Tensor  # f32[E]
    huber_weights: torch.Tensor  # f32[E]


def compute_arap_term(
    edges, node_positions_virtual, node_rotations_virtual, node_translations_virtual,
    edge_weights, arap_term_weight: float, huber_constant: float | None = None,
) -> ArapTerm:
    """Residuals + jacobian factors for all hierarchy edges."""
    i = edges[:, 0].long()
    j = edges[:, 1].long()
    g_i = node_positions_virtual[i]
    g_j = node_positions_virtual[j]
    t_i = node_translations_virtual[i]
    t_j = node_translations_virtual[j]
    r_mat = node_rotations_virtual[i]
    c = arap_term_weight * edge_weights
    rotated = torch.einsum("eab,eb->ea", r_mat, g_i - g_j)
    residuals = c[:, None] * ((g_i + t_i) - (g_j + t_j) - rotated)
    rot_jac = c[:, None, None] * skew(rotated)
    if huber_constant is None:
        hw = torch.ones(edges.shape[0], dtype=torch.float32, device=edges.device)
    else:
        norm = torch.linalg.norm(residuals, dim=-1)
        hw = torch.where(
            norm <= huber_constant, 1.0, huber_constant / torch.clamp(norm, min=1e-12)
        )
    return ArapTerm(residuals, rot_jac, c, hw)


def edge_weights_fixed(edge_layer_indices, layer_decimation_radii: tuple) -> torch.Tensor:
    radii = torch.tensor(layer_decimation_radii, dtype=torch.float32, device=edge_layer_indices.device)
    return radii[edge_layer_indices.long()]


def edge_weights_variable(edges, node_coverage_weights_squared_virtual) -> torch.Tensor:
    cov = torch.sqrt(node_coverage_weights_squared_virtual)
    return torch.maximum(cov[edges[:, 0].long()], cov[edges[:, 1].long()])


def assemble_arap_normal_equations(
    term: ArapTerm, edges, num_nodes: int, arrow_base: int, max_wing_degree: int,
):
    """Accumulate the ARAP term into arrowhead-structured normal equations.

    Returns (stem_diag f32[N0,6,6], wing f32[N0,K,6,6], wing_cols int32[N0,K],
    corner f32[(N-N0)*6,(N-N0)*6], gradient f32[N*6]), gradient = -J^T r, in
    virtual node order with rotation dofs first within each 6-block.
    """
    dev = edges.device
    e = edges.shape[0]
    i = edges[:, 0].long()
    j = edges[:, 1].long()
    n0 = arrow_base
    nc = num_nodes - arrow_base
    sq = torch.sqrt(term.huber_weights)
    c = term.translation_scale * sq
    jr = term.rotation_jacobian_i * sq[:, None, None]
    r = term.residuals * sq[:, None]

    jr_t_jr = torch.einsum("eab,eac->ebc", jr, jr)
    jr_t_c = jr.transpose(-1, -2) * c[:, None, None]
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    c2_eye = (c**2)[:, None, None] * eye3

    def six_block(rr, rt, tr, tt):
        return torch.cat([torch.cat([rr, rt], dim=-1), torch.cat([tr, tt], dim=-1)], dim=-2)

    zeros3 = torch.zeros_like(jr_t_jr)
    h_ii = six_block(jr_t_jr, jr_t_c, jr_t_c.transpose(-1, -2), c2_eye).reshape(e, 36)
    h_ij = six_block(zeros3, -jr_t_c, zeros3, -c2_eye).reshape(e, 36)
    h_jj = six_block(zeros3, zeros3, zeros3, c2_eye).reshape(e, 36)

    # gradient -J^T r
    gi_rot = -torch.einsum("eab,ea->eb", jr, r)
    gi_trans = -c[:, None] * r
    gj_trans = c[:, None] * r
    g_rot = segment_sum(gi_rot, i, num_nodes)
    g_trans = segment_sum(gi_trans, i, num_nodes) + segment_sum(gj_trans, j, num_nodes)
    g = torch.cat([g_rot, g_trans], dim=-1)

    # diagonal blocks: stem rows and corner rows
    stem_diag = segment_sum(h_ii, i, n0).reshape(n0, 6, 6)  # corner rows dropped
    nc1 = max(nc, 1)
    ci_d = torch.where((i >= n0) & (nc > 0), i - n0, nc1)
    cj_d = torch.where((j >= n0) & (nc > 0), j - n0, nc1)
    corner_blocks_diag = (
        segment_sum(h_ii, ci_d, nc1) + segment_sum(h_jj, cj_d, nc1)
    ).reshape(nc1, 6, 6)

    # wing: edges with a stem source, slot = rank within the source's edges
    is_stem_edge = i < n0
    idx = torch.arange(e, device=dev)
    src_key = torch.where(is_stem_edge, i, n0)
    _, sorted_order = torch.sort(src_key, stable=True)
    ssrc = src_key[sorted_order]
    head = torch.ones(e, dtype=torch.bool, device=dev)
    head[1:] = ssrc[1:] != ssrc[:-1]
    first = torch.cummax(torch.where(head, idx, 0), dim=0).values
    slot = torch.zeros(e, dtype=torch.int64, device=dev)
    slot[sorted_order] = idx - first
    ok = is_stem_edge & (slot < max_wing_degree)
    wid = torch.where(ok, i * max_wing_degree + slot, n0 * max_wing_degree)
    wing = segment_sum(h_ij, wid, n0 * max_wing_degree).reshape(n0, max_wing_degree, 6, 6)
    wing_cols = torch.full((n0 * max_wing_degree + 1,), -1, dtype=torch.int32, device=dev)
    wing_cols[wid] = torch.where(ok, j - n0, -1).to(torch.int32)
    wing_cols = wing_cols[: n0 * max_wing_degree].reshape(n0, max_wing_degree)

    # corner off-diagonals: edges between coarser layers
    coarse_edge = i >= n0
    ci = torch.clamp(i - n0, min=0)
    cj = torch.clamp(j - n0, min=0)
    flat_idx = torch.where(coarse_edge, ci * nc1 + cj, nc1 * nc1)
    off = segment_sum(h_ij, flat_idx, nc1 * nc1).reshape(nc1, nc1, 6, 6)
    corner = off.permute(0, 2, 1, 3) + off.permute(1, 3, 0, 2)
    diag_idx = torch.arange(nc1, device=dev)
    corner[diag_idx, :, diag_idx, :] += corner_blocks_diag
    return stem_diag, wing, wing_cols, corner.reshape(nc1 * 6, nc1 * 6), g.reshape(-1)
