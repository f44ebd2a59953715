"""``ops/segment_sum.py`` against the JAX package's segment sums.

Both card forms (the chunked one-hot product and the sorted piece sums) run
here on CPU tensors, at each call site's shape at a small size, against
``jax.ops.segment_sum`` and the JAX fitter's ``_segment_sum_mxu``: within
1e-6 of the largest entry in f32 and 1e-12 in f64. Rows whose segment is
out of range carry NaN and Inf and must be dropped; the dispatcher on a CPU
tensor is ``index_add_`` bit for bit; the gradient is a gather, held to
autograd through ``index_add_`` in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu.models.fitter import _segment_sum_mxu
from dynamicfuion_python_tpu_torch.ops import segment_sum as ss

CARD_FORMS = {"onehot": ss.segment_sum_onehot, "sorted": ss.segment_sum_sorted}
RTOL = {np.float32: 1e-6, np.float64: 1e-12}

# each call site's shape at a small size: (rows, row shape, segments)
SITES = {
    "fitter_data_term": (3000, (42,), 20),  # pixel slots x (36 H + 6 g) into nodes
    "arap_blocks": (120, (36,), 30),  # edges into nodes / wing slots / corner pairs
    "arrowhead_schur_pairs": (144, (36,), 9),  # stem wing-slot pairs into corner pairs
    "arrowhead_wing_t": (48, (6,), 3),  # B^T v
    "mesh_vertex_normals": (900, (3,), 400),  # 3 corners x faces into vertices
    "prior_pair_blocks": (2400, (6, 6), 144),  # matches x 16 anchor pairs into nodes^2
    "deform_net_node_weights": (2000, (), 12),  # pixel anchors into nodes
    "sampling_cell_sums": (700, (3,), 90),  # points into grid cells (f64 on every device)
}


def _site_inputs(site: str, dtype, seed: int = 0):
    """Seeded values and segments: a tenth of the rows dropped (segment -1,
    -7 or num_segments + 3), carrying NaN / Inf / -Inf; two segments left
    empty."""
    rows, shape, n = SITES[site]
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(rows, *shape)).astype(dtype)
    seg = rng.integers(0, n, size=rows)
    seg = np.where(np.isin(seg, [1, n - 2]), 0, seg)  # empty segments
    dropped = rng.random(rows) < 0.1
    seg = np.where(dropped, rng.choice([-1, -7, n + 3], size=rows), seg)
    poison = np.array([np.nan, np.inf, -np.inf], dtype)[rng.integers(0, 3, size=rows)]
    values[dropped] = poison[dropped].reshape(-1, *([1] * len(shape)))
    return values, seg.astype(np.int32), n


def _tol(want, dtype) -> float:
    return RTOL[dtype] * max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("form", sorted(CARD_FORMS))
@pytest.mark.parametrize("site", sorted(SITES))
def test_card_form_matches_jax_segment_sum(site, form, dtype):
    values, seg, n = _site_inputs(site, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(seg), num_segments=n))
        # the JAX package zeroes dropped rows before its one-hot product
        kept = ((seg >= 0) & (seg < n)).reshape(-1, *([1] * (values.ndim - 1)))
        flat = np.where(kept, values, 0).reshape(len(seg), -1)
        mxu = np.asarray(_segment_sum_mxu(jnp.asarray(flat), jnp.asarray(seg), n, chunk=512))
    assert want.dtype == dtype
    got = CARD_FORMS[form](torch.from_numpy(values), torch.from_numpy(seg), n).numpy()
    assert got.shape == want.shape and got.dtype == dtype
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want, dtype))
    np.testing.assert_allclose(got.reshape(n, -1), mxu, rtol=0, atol=_tol(mxu, dtype))
    for empty in (1, n - 2):
        assert not got[empty].any()


@pytest.mark.parametrize("form", sorted(CARD_FORMS))
def test_card_form_adds_onto_acc(form):
    values, seg, n = _site_inputs("fitter_data_term", np.float32, seed=1)
    acc = np.random.default_rng(2).normal(size=(n, 42)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jnp.asarray(acc) + jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(seg), num_segments=n))
    got = CARD_FORMS[form](torch.from_numpy(values), torch.from_numpy(seg), n, acc=torch.from_numpy(acc))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_tol(want, np.float32))


@pytest.mark.parametrize("form", sorted(CARD_FORMS))
def test_card_form_edge_shapes(form):
    """No rows, every row dropped, a single segment, and more rows than one
    one-hot group or one level of pieces."""
    f = CARD_FORMS[form]
    empty = f(torch.zeros((0, 3)), torch.zeros((0,), dtype=torch.int64), 4)
    assert empty.shape == (4, 3) and not empty.any()
    dropped = f(torch.full((5, 2), float("nan")), torch.full((5,), 7), 3)
    assert dropped.shape == (3, 2) and not dropped.any()
    rng = np.random.default_rng(3)
    values = rng.normal(size=(40_000, 2))
    seg = np.where(rng.random(40_000) < 0.5, 0, rng.integers(0, 3, size=40_000))
    got = f(torch.from_numpy(values), torch.from_numpy(seg), 3).numpy()
    want = np.stack([values[seg == k].sum(0) for k in range(3)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("acc", [False, True], ids=["plain", "acc"])
def test_cpu_dispatch_is_index_add_bit_for_bit(acc):
    """On a CPU tensor ``segment_sum`` is ``index_add_`` in index order, as
    the port summed before (the chained SPMD sums rely on it)."""
    values, seg, n = _site_inputs("prior_pair_blocks", np.float32, seed=4)
    v, s = torch.from_numpy(values), torch.from_numpy(seg).long()
    base = torch.from_numpy(np.random.default_rng(5).normal(size=(n, 6, 6)).astype(np.float32))
    want = torch.cat([base if acc else torch.zeros_like(base), torch.zeros((1, 6, 6))])
    want.index_add_(0, torch.where((s >= 0) & (s < n), s, n), v)
    got = ss.segment_sum(v, s, n, acc=base if acc else None)
    assert torch.equal(got, want[:n])


@pytest.mark.parametrize("form", ["cpu", *sorted(CARD_FORMS)])
def test_gradient_is_a_gather(form):
    """The gradient of the sum with respect to the rows and to ``acc``,
    against autograd through ``index_add_``, in f64."""
    values, seg, n = _site_inputs("arap_blocks", np.float64, seed=6)
    values = np.nan_to_num(values, nan=0.5, posinf=2.0, neginf=-2.0)
    s = torch.from_numpy(seg).long()
    weights = torch.from_numpy(np.random.default_rng(7).normal(size=(n, 36)))
    grads = []
    for use_index_add in (True, False):
        v = torch.from_numpy(values).requires_grad_(True)
        acc = torch.ones((n, 36), dtype=torch.float64, requires_grad=True)
        if use_index_add:
            dest = torch.where((s >= 0) & (s < n), s, n)
            out = torch.cat([acc, torch.zeros((1, 36), dtype=torch.float64)]).index_add(0, dest, v)[:n]
        elif form == "cpu":
            out = ss.segment_sum(v, s, n, acc=acc)
        else:
            out = ss._SegmentSum.apply(v, s, acc, n, CARD_FORMS[form])
        (out * weights).sum().backward()
        grads.append((v.grad, acc.grad))
    np.testing.assert_allclose(grads[1][0].numpy(), grads[0][0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(grads[1][1].numpy(), grads[0][1].numpy(), rtol=0, atol=1e-12)
    assert not grads[1][0][(s < 0) | (s >= n)].any()
