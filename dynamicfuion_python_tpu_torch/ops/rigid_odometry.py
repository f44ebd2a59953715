"""Multi-scale projective point-to-plane ICP (rigid RGB-D odometry); port of
``dynamicfuion_python_tpu/ops/rigid_odometry.py``.

Estimates the rigid camera transform between two depth frames by
coarse-to-fine Gauss-Newton over projective associations. Per iteration at
each level: transform the source points by the current estimate, project
them into the target frame, read the target point + normal there, form the
residual r = dot(n_t, T p_s - p_t) with jacobian [(T p_s) x n_t, n_t] per
pixel, solve the damped 6x6 normal equations and update T on the left by the
exponential map. Pyramid levels are strided min-pools that ignore zeros.

The JAX loop stops once an update's largest entry is at most 1e-7. Here every
level runs its fixed iteration count with a device-side "still running" flag
that freezes the transform and the rmse once it goes false: the same result,
and no host synchronisation anywhere in the call.

With a process group (``group``) each rank sums the normal equations over
its own rows of the source image at every level (the target stays whole:
a projective association may land in any row) and one ``all_reduce`` per
iteration sums them.
"""

from __future__ import annotations

import torch

from dynamicfuion_python_tpu_torch.ops.camera import unproject_depth_image
from dynamicfuion_python_tpu_torch.ops.linalg.rodrigues import axis_angle_to_matrix
from dynamicfuion_python_tpu_torch.ops.normals import point_image_normals
from dynamicfuion_python_tpu_torch.parallel import spmd


def _downsample_depth(depth: torch.Tensor, factor: int) -> torch.Tensor:
    """Min-pool (ignoring zeros) depth downsampling."""
    h, w = depth.shape
    hp, wp = h // factor * factor, w // factor * factor
    d = depth[:hp, :wp].reshape(hp // factor, factor, wp // factor, factor).to(torch.float32)
    pooled = torch.amin(torch.where(d > 0, d, torch.inf), dim=(1, 3))
    return torch.where(torch.isfinite(pooled), pooled, 0.0)


def _icp_level(
    source_points,
    source_mask,
    target_points,
    target_normals,
    target_mask,
    intrinsics,
    transform,
    iterations: int,
    distance_threshold: float,
    update_threshold: float = 1e-7,
    group=None,
):
    """``iterations`` Gauss-Newton steps from ``transform``; returns the
    transform and rmse of the last step taken before the largest update
    entry fell to ``update_threshold`` or below."""
    h, w = source_mask.shape
    dev = source_points.device
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    r0, r1 = (0, h) if group is None else spmd.row_range(h, group)
    src = source_points[r0:r1].reshape(-1, 3)
    src_ok = source_mask[r0:r1].reshape(-1)
    # target point, normal and validity packed into one 8-wide row table: the
    # projective association is a single row gather per iteration
    t_valid = target_mask & (torch.linalg.norm(target_normals, dim=-1) > 0.1)
    target_tbl = torch.cat(
        [
            target_points.reshape(-1, 3),
            target_normals.reshape(-1, 3),
            t_valid.reshape(-1, 1).to(torch.float32),
            torch.zeros((h * w, 1), dtype=torch.float32, device=dev),
        ],
        dim=1,
    )
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    damping = 1e-6 * torch.eye(6, dtype=torch.float32, device=dev)
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    running = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(iterations):
        rot = transform[:3, :3]
        tr = transform[:3, 3]
        moved = src @ rot.T + tr
        z = torch.clamp(moved[:, 2], min=1e-6)
        # round half to even, as jnp.round does
        u = torch.round(moved[:, 0] / z * fx + cx).to(torch.int64)
        v = torch.round(moved[:, 1] / z * fy + cy).to(torch.int64)
        inb = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (moved[:, 2] > 0)
        flat = torch.clamp(v, 0, h - 1) * w + torch.clamp(u, 0, w - 1)
        row = target_tbl[flat]  # [P, 8]
        q = row[:, 0:3]
        n = row[:, 3:6]
        t_ok = row[:, 6] > 0.5
        r = torch.sum(n * (moved - q), dim=-1)
        ok = src_ok & inb & t_ok & (torch.abs(r) < distance_threshold)
        wgt = ok.to(torch.float32)
        # jacobian rows [(T p) x n | n] of r = n . (R p + t - q) under a
        # left-multiplied increment exp([w]x) T
        jac = torch.cat([torch.linalg.cross(moved, n), n], dim=-1)  # [P, 6]
        # the sums over pixels accumulate in f64: a CPU matrix product splits
        # them by the thread count, and in f32 that moved the pose by up to
        # 2.5e-7 between thread counts (the fits after it grow that to
        # 1.5e-4 m); in f64 the f32 result is the same for any split
        wj = (jac * wgt[:, None]).double()
        ata, atb = wj.T @ jac.double(), wj.T @ r.double()
        err, count = torch.sum(wgt * r * r), torch.sum(wgt)
        if group is not None:
            ata, atb, err, count = spmd.all_reduce_sum([ata, atb, err, count], group)
        a = ata.float() + damping
        b = -atb.float()
        # solve_ex reports a singular system in its info tensor instead of
        # checking it on the host
        delta = torch.linalg.solve_ex(a, b)[0]
        d_rot = axis_angle_to_matrix(delta[:3])
        new_rot = d_rot @ rot
        new_tr = d_rot @ tr + delta[3:]
        new_t = torch.cat([torch.cat([new_rot, new_tr[:, None]], dim=1), eye4[3:]], dim=0)
        new_rmse = torch.sqrt(err / torch.clamp(count, min=1.0))
        transform = torch.where(running, new_t, transform)
        rmse = torch.where(running, new_rmse, rmse)
        running = running & (torch.amax(torch.abs(delta)) > update_threshold)
    return transform, rmse


def rigid_odometry_multi_scale(
    source_depth: torch.Tensor,
    target_depth: torch.Tensor,
    intrinsics: torch.Tensor,
    initial_transform: torch.Tensor | None = None,
    levels: tuple = (4, 2, 1),
    iterations_per_level: int = 10,
    depth_scale: float = 1000.0,
    depth_max: float = 3.0,
    distance_threshold: float = 0.07,
    group=None,
):
    """Estimate T such that T * source ~= target, on the device of the
    depth images; with ``group``, each rank sums its own source rows.
    Returns (T f32[4, 4], final rmse f32[])."""
    dev = source_depth.device
    intrinsics = intrinsics.to(device=dev, dtype=torch.float32)
    if initial_transform is None:
        transform = torch.eye(4, dtype=torch.float32, device=dev)
    else:
        transform = initial_transform.to(device=dev, dtype=torch.float32)
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    for factor in levels:
        if factor > 1:
            sd = _downsample_depth(source_depth, factor)
            td = _downsample_depth(target_depth, factor)
        else:
            sd = source_depth.to(torch.float32)
            td = target_depth.to(torch.float32)
        # the pixel rows scale; the last row stays (0, 0, 1) (a setitem of a
        # Python scalar would copy it from the host)
        intr = torch.cat([intrinsics[:2] / factor, intrinsics[2:]])
        sp, sm = unproject_depth_image(sd, intr, depth_scale, depth_max)
        tp, tm = unproject_depth_image(td, intr, depth_scale, depth_max)
        tn = point_image_normals(tp)
        transform, rmse = _icp_level(
            sp, sm, tp, tn, tm, intr, transform, iterations_per_level, distance_threshold, group=group
        )
    return transform, rmse
