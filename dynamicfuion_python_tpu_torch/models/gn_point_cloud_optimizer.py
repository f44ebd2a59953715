"""Gauss-Newton point-cloud alignment, the neural tracker's solver (port of
``dynamicfuion_python_tpu/models/gn_point_cloud_optimizer.py``).

Per iteration: data residuals [flow-u, flow-v, depth] per correspondence with
jacobians with respect to its 4 anchor nodes' axis-angle + translation
deltas (``torch.func``: ``vmap(jacrev)``), ARAP residuals over the flat graph
edges (analytic jacobians), A = J^T J + lm I and b = -J^T r assembled per
node pair (one ``ops/segment_sum.py`` sum of the [M, 4, 4, 6, 6]
anchor-pair blocks and the edges' blocks into [N * N, 6, 6], in a fixed
order on the card), a dense solve and the axis-angle update. The dense
[3M x 6N] jacobian is never formed. A step whose factorization fails (``lu_factor_ex``
reports it in ``info``), comes out non-finite or trips the optional
condition-number cutoff marks the solve invalid and freezes the transforms;
nothing syncs with the host.

Training differentiates through the whole solve: the jacobians
(``vmap(jacrev)`` inside the outer autograd graph), the assembly and the
dense solve. The system is factored once per iteration; a discarded step
swaps in the identity's factors, so its backward never meets a failed
factorization and its gradients stay finite.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dynamicfuion_python_tpu_torch.ops.linalg.rodrigues import axis_angle_to_matrix, skew
from dynamicfuion_python_tpu_torch.ops.segment_sum import segment_sum
from dynamicfuion_python_tpu_torch.ops.warp import gather_rows


class GnConfig(NamedTuple):
    """Defaults as in the JAX package (the reference's deform-net settings)."""

    num_iterations: int = 3
    lm_factor: float = 0.1
    lambda_data_flow: float = 1.0
    lambda_data_depth: float = 1.0
    lambda_arap: float = 1.0
    use_edge_weighting: bool = False
    check_condition_num: bool = False
    break_on_condition_num: bool = True
    max_condition_num: float = 1e6


class GnResult(NamedTuple):
    """Solve outputs. ``valid_solve`` false means some iteration failed its
    guards; the transforms are then the last valid state."""

    rotations: torch.Tensor  # f32[N, 3, 3]
    translations: torch.Tensor  # f32[N, 3]
    losses: torch.Tensor  # f32[iterations]
    valid_solve: torch.Tensor  # bool[]
    condition_numbers: torch.Tensor  # f32[iterations] (inf when not checked)


class _FactoredSolve(torch.autograd.Function):
    """``x = A^-1 b`` from LU factors of ``A`` made outside the autograd
    graph: the forward and the backward's adjoint solve reuse them (as
    ``torch.linalg.solve``'s own backward reuses its LU). ``a`` only carries
    the gradient, ``-A^-T g x^T``."""

    @staticmethod
    def forward(a, b, lu, pivots):
        return torch.linalg.lu_solve(lu, pivots, b[:, None])[:, 0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2], inputs[3], output)

    @staticmethod
    def backward(ctx, grad_x):
        lu, pivots, x = ctx.saved_tensors
        grad_b = torch.linalg.lu_solve(lu, pivots, grad_x[:, None], adjoint=True)[:, 0]
        return -grad_b[:, None] * x[None, :], grad_b, None, None


def _match_residual(
    delta, source_point, anchor_nodes, anchor_weights, rot, trans, target_uv, target_z, intrinsics,
    lambda_flow: float, lambda_depth: float,
):
    """[flow-u, flow-v, depth] residual of one correspondence as a function
    of its anchors' deltas [4, 6]."""
    d_rot = axis_angle_to_matrix(delta[:, :3])
    r = torch.einsum("kab,kbc->kac", d_rot, rot)
    t = trans + delta[:, 3:]
    rotated = torch.einsum("kab,kb->ka", r, source_point[None] - anchor_nodes)
    deformed = torch.einsum("k,ka->a", anchor_weights, anchor_nodes + rotated + t)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    inv_z = 1.0 / (deformed[2] + 1e-7)
    u = fx * deformed[0] * inv_z + cx
    v = fy * deformed[1] * inv_z + cy
    return torch.stack([
        lambda_flow * (u - target_uv[0]), lambda_flow * (v - target_uv[1]), lambda_depth * (deformed[2] - target_z),
    ])


_IN_DIMS = (None, 0, 0, 0, 0, 0, 0, 0, None)


def _match_residuals_and_jacobians(config: GnConfig, *args):
    fn = functools.partial(_match_residual, lambda_flow=config.lambda_data_flow, lambda_depth=config.lambda_data_depth)
    jac = torch.func.vmap(torch.func.jacrev(fn, argnums=0), in_dims=_IN_DIMS)(*args)  # [M, 3, 4, 6]
    res = torch.func.vmap(fn, in_dims=_IN_DIMS)(*args)  # [M, 3]
    return res, jac


def _edge_residual_jacobian(nodes, rot, trans, edges, edge_weights, config: GnConfig):
    """ARAP residuals [E, 3], d res / d rot_i [E, 3, 3] and the weights."""
    i = edges[:, 0]
    j = edges[:, 1]
    w = (edge_weights if config.use_edge_weighting else torch.ones_like(edge_weights)) * config.lambda_arap
    rotated = torch.einsum("eab,eb->ea", gather_rows(rot, i), nodes[j] - nodes[i])
    res = w[:, None] * (rotated + nodes[i] + gather_rows(trans, i) - (nodes[j] + gather_rows(trans, j)))
    return res, -w[:, None, None] * skew(rotated), w


def optimize_point_cloud_alignment(
    graph_nodes: torch.Tensor,  # f32[N, 3]
    graph_edges: torch.Tensor,  # int[N, Ke] (-1 pad)
    graph_edge_weights: torch.Tensor,  # f32[N, Ke]
    source_points: torch.Tensor,  # f32[M, 3]
    source_anchors: torch.Tensor,  # int[M, 4]
    source_anchor_weights: torch.Tensor,  # f32[M, 4]
    correspondence_weights: torch.Tensor,  # f32[M] (0 = padding / invalid)
    target_uv: torch.Tensor,  # f32[M, 2] flow-warped pixel targets
    target_z: torch.Tensor,  # f32[M]
    intrinsics: torch.Tensor,
    num_nodes: int,
    config: GnConfig = GnConfig(),
    initial_rotations: torch.Tensor | None = None,
    initial_translations: torch.Tensor | None = None,
) -> GnResult:
    """The GN solve on the device of its inputs; returns a :class:`GnResult`."""
    n = num_nodes
    dev = graph_nodes.device
    dtype = source_points.dtype  # the inputs' (f32 on the port's paths)
    rot = (
        initial_rotations if initial_rotations is not None
        else torch.eye(3, dtype=dtype, device=dev).expand(n, 3, 3)
    )
    trans = initial_translations if initial_translations is not None else torch.zeros((n, 3), dtype=dtype, device=dev)
    if config.num_iterations == 0:
        # the reference's skip-solver mode: identity transforms, trivially valid
        return GnResult(rot, trans, torch.zeros((1,), device=dev), torch.ones((), dtype=torch.bool, device=dev),
                        torch.full((1,), torch.inf, device=dev))

    # flat edge pairs
    ke = graph_edges.shape[1]
    src = torch.arange(n, device=dev).repeat_interleave(ke)
    dst = graph_edges.reshape(-1).long()
    edge_ok = dst >= 0
    pairs = torch.stack([src, dst.clamp(min=0)], dim=1)
    pair_w = torch.where(edge_ok, graph_edge_weights.reshape(-1) * ke, 0.0)
    i_idx, j_idx = pairs[:, 0], pairs[:, 1]
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    safe_anchor = source_anchors.clamp(min=0).long()
    anchor_w = torch.where(source_anchors >= 0, source_anchor_weights, 0.0)
    anchor_nodes = gather_rows(graph_nodes, safe_anchor)  # [M, 4, 3]
    # the segments of the system's rows: anchor pairs, then the edges' four
    # blocks (node pair i * n + j); anchors, then the edges' two nodes
    pair_seg = (safe_anchor[:, :, None] * n + safe_anchor[:, None, :]).reshape(-1)
    h_seg = torch.cat([pair_seg, i_idx * n + i_idx, i_idx * n + j_idx, j_idx * n + i_idx, j_idx * n + j_idx])
    g_seg = torch.cat([safe_anchor.reshape(-1), i_idx, j_idx])
    cw = correspondence_weights
    zero_delta = torch.zeros((4, 6), dtype=dtype, device=dev)
    eye = torch.eye(6 * n, dtype=dtype, device=dev)
    identity_pivots = torch.arange(1, 6 * n + 1, dtype=torch.int32, device=dev)  # LAPACK's, 1-based
    valid = torch.ones((), dtype=torch.bool, device=dev)
    losses, condition_numbers = [], []
    for _ in range(config.num_iterations):
        res, jac = _match_residuals_and_jacobians(
            config, zero_delta, source_points, anchor_nodes, anchor_w,
            gather_rows(rot, safe_anchor), gather_rows(trans, safe_anchor),
            target_uv, target_z, intrinsics,
        )
        jac = jac * cw[:, None, None, None]
        res_w = res * cw[:, None]

        # ARAP: J_i = [jrot | w I], J_j = [0 | -w I]
        e_res, e_jrot, e_w = _edge_residual_jacobian(graph_nodes, rot, trans, pairs, pair_w, config)
        e_res = e_res * edge_ok[:, None]
        e_jrot = e_jrot * edge_ok[:, None, None]
        e_w = e_w * edge_ok
        j_i = torch.cat([e_jrot, e_w[:, None, None] * eye3], dim=-1)  # [E, 3, 6]
        j_j = torch.cat([torch.zeros_like(e_jrot), -e_w[:, None, None] * eye3], dim=-1)
        blocks_ij = torch.einsum("eab,eac->ebc", j_i, j_j)

        # J^T J and -J^T r in one sum each: the data term's anchor-pair
        # blocks, then the ARAP blocks (ii, ij, ji, jj), into [N * N, 6, 6]
        h = segment_sum(torch.cat([
            torch.einsum("mrka,mrlb->mklab", jac, jac).reshape(-1, 6, 6),
            torch.einsum("eab,eac->ebc", j_i, j_i),
            blocks_ij,
            blocks_ij.transpose(-1, -2),
            torch.einsum("eab,eac->ebc", j_j, j_j),
        ]), h_seg, n * n)
        g = segment_sum(torch.cat([
            -torch.einsum("mrka,mr->mka", jac, res_w).reshape(-1, 6),
            -torch.einsum("eab,ea->eb", j_i, e_res),
            -torch.einsum("eab,ea->eb", j_j, e_res),
        ]), g_seg, n)

        # dense system; a failed factorization counts as a non-finite step
        h_dense = h.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n) + config.lm_factor * eye
        g_flat = g.reshape(-1)
        if config.check_condition_num:
            # a guard only: the eigenvalues feed a boolean, never a gradient
            eigs = torch.abs(torch.linalg.eigvalsh(h_dense.detach()))
            condition_number = torch.amax(eigs) / torch.clamp(torch.amin(eigs), min=1e-30)
            if config.break_on_condition_num:
                cond_ok = torch.isfinite(condition_number) & (condition_number <= config.max_condition_num)
            else:
                cond_ok = torch.ones((), dtype=torch.bool, device=dev)
        else:
            condition_number = torch.full((), torch.inf, device=dev)
            cond_ok = torch.ones((), dtype=torch.bool, device=dev)
        lu, pivots, info = torch.linalg.lu_factor_ex(h_dense.detach())
        probe = torch.linalg.lu_solve(lu, pivots, g_flat.detach()[:, None])
        step_ok = torch.all(torch.isfinite(probe)) & cond_ok & (info == 0)
        # a discarded step solves the identity for 0: its backward then never
        # meets the failed factors (0 * NaN is NaN), and the delta is 0
        lu = torch.where(step_ok, lu, eye)
        pivots = torch.where(step_ok, pivots, identity_pivots)
        delta = _FactoredSolve.apply(h_dense, torch.where(step_ok, g_flat, 0.0), lu, pivots).reshape(n, 6)
        valid = valid & step_ok

        new_rot = torch.einsum("nab,nbc->nac", axis_angle_to_matrix(delta[:, :3]), rot)
        new_trans = trans + delta[:, 3:]
        rot = torch.where(valid, new_rot, rot)
        trans = torch.where(valid, new_trans, trans)
        losses.append(torch.sum(res_w**2) + torch.sum(e_res**2))
        condition_numbers.append(condition_number)
    losses = torch.stack(losses)
    # the final residuals must be finite too
    valid = valid & torch.isfinite(losses[-1])
    return GnResult(rot, trans, losses, valid, torch.stack(condition_numbers))
