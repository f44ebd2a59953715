"""Brute-force K-nearest-neighbor search (port of
``dynamicfuion_python_tpu/ops/knn.py``).

One dense distance matrix per query chunk, then ``k`` repeated argmin passes.
``torch.argmin`` returns the first minimum, which is the JAX package's tie
order; ``torch.topk`` would leave the order of exact distance ties
unspecified, and the node sets sampled from regular meshes do have them.
"""

from __future__ import annotations

import torch

#: elements of the [chunk, N] distance matrix (times k + 1 live copies)
_DENSE_BUDGET_ELEMS = 64 << 20


def _squared_norm(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares along the last axis accumulated by fused multiply-adds
    (each product exact, one rounding per step), as XLA fuses the JAX
    package's ``jnp.sum(a * a)``: under the expansion's cancellation a one-ulp
    difference here decides near-ties between nodes."""
    x64 = x.to(torch.float64)
    acc = (x64[..., 0] * x64[..., 0]).to(torch.float32)
    for k in range(1, x.shape[-1]):
        acc = (x64[..., k] * x64[..., k] + acc.to(torch.float64)).to(torch.float32)
    return acc[..., None]


def squared_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M,3] x [N,3] -> [M,N] squared distances by the |a|^2 + |b|^2 - 2ab
    expansion."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    aa = _squared_norm(a)
    bb = _squared_norm(b)
    cross = torch.matmul(a, b.T)
    return torch.clamp(aa + bb.T - 2.0 * cross, min=0.0)


def _knn_dense(queries: torch.Tensor, references: torch.Tensor, k: int):
    work = squared_distance_matrix(queries, references)
    cols = torch.arange(references.shape[0], device=references.device)
    vals, idxs = [], []
    for _ in range(k):
        v = torch.amin(work, dim=1)
        i = torch.argmin(work, dim=1)
        vals.append(v)
        idxs.append(i.to(torch.int32))
        work = torch.where(cols[None, :] == i[:, None], torch.inf, work)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def knn(
    queries: torch.Tensor, references: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact K nearest references for each query point.

    queries f32[..., 3], references f32[N, 3] -> (squared distances
    f32[..., k], indices int32[..., k]) sorted ascending.
    """
    lead_shape = queries.shape[:-1]
    flat = queries.reshape(-1, queries.shape[-1])
    m = flat.shape[0]
    n = references.shape[0]
    k = min(k, n)
    chunk = max(1, _DENSE_BUDGET_ELEMS // max(1, n * (k + 1)))
    if m <= chunk:
        d, i = _knn_dense(flat, references, k)
    else:
        parts = [_knn_dense(flat[s : s + chunk], references, k) for s in range(0, m, chunk)]
        d = torch.cat([p[0] for p in parts])
        i = torch.cat([p[1] for p in parts])
    return d.reshape(*lead_shape, k), i.reshape(*lead_shape, k)
