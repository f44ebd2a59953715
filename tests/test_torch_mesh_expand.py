"""Kernel B2 (indexed-mesh face expansion + projection): the plain PyTorch
version against the JAX package's Pallas kernel (interpret mode, permuted
back by the plan) and against extract_face_vertices; on a card, the CUDA
kernel against the plain version
(tests/test_torch_kernels_gpu.py)."""

import numpy as np
import jax.numpy as jnp
import torch

from dynamicfuion_python_tpu.ops.pallas.mesh_expand import ExpansionPlan, expand_project_faces as j_expand
from dynamicfuion_python_tpu.ops.rasterize import extract_face_vertices as j_extract
from dynamicfuion_python_tpu_torch.ops.mesh_expand import (
    expand_project_faces,
    expand_project_faces_plain,
)

INTR = np.asarray([[120.0, 0.0, 32.0], [0.0, 120.0, 32.0], [0.0, 0.0, 1.0]], np.float32)


def _mesh(rng, n_verts=400, n_faces=900):
    verts = (rng.normal(size=(n_verts, 3)) * [0.2, 0.2, 0.1] + [0, 0, 2.0]).astype(np.float32)
    verts[::7, 2] = 0.01  # behind the near plane: a non-trivial clip mask
    verts[::11, 2] = 12.0  # beyond the far plane
    faces = rng.integers(0, n_verts, size=(n_faces, 3)).astype(np.int32)
    return verts, faces


def test_plain_matches_pallas_kernel_and_extract(rng):
    verts, faces = _mesh(rng)
    plan = ExpansionPlan(faces, len(verts), chunk=128)
    jfv, jvalid, _ = j_expand(jnp.asarray(verts), plan, jnp.asarray(INTR))
    rfv, rvalid = j_extract(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(INTR), (64, 64))
    fv, valid, s2o = expand_project_faces(torch.as_tensor(verts), torch.as_tensor(faces), torch.as_tensor(INTR))
    perm = np.asarray(plan.perm)
    # the Pallas kernel returns faces in its min-vertex-id order
    np.testing.assert_allclose(fv.numpy()[perm], np.asarray(jfv), rtol=2e-6, atol=1e-6)
    np.testing.assert_array_equal(valid.numpy()[perm], np.asarray(jvalid))
    np.testing.assert_allclose(fv.numpy(), np.asarray(rfv), rtol=2e-6, atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    assert 0 < valid.numpy().sum() < len(faces)
    np.testing.assert_array_equal(s2o.numpy(), np.arange(len(faces)))


def test_near_far_arguments(rng):
    verts, faces = _mesh(rng)
    for near, far in ((1e-3, 10.0), (0.05, 20.0)):
        rfv, rvalid = j_extract(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(INTR), (64, 64), near=near, far=far)
        fv, valid = expand_project_faces_plain(torch.as_tensor(verts), torch.as_tensor(faces), torch.as_tensor(INTR), near, far)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
        np.testing.assert_allclose(fv.numpy(), np.asarray(rfv), rtol=2e-6, atol=1e-6)

