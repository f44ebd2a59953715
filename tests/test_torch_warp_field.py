"""PyTorch port vs JAX package: HierarchicalGraphWarpField.build from the
same nodes gives identical layers, virtual order, edges and arrow base; the
virtual-order updates agree."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfuion_python_tpu.models.warp_field import (
    HierarchicalGraphWarpField as JH,
    NodeCoverageMethod as JNC,
)
from dynamicfuion_python_tpu_torch.models.warp_field import (
    HierarchicalGraphWarpField as PH,
    NodeCoverageMethod as PNC,
)
from dynamicfuion_python_tpu_torch.utils.state_conversion import (
    warp_field_from_numpy,
    warp_field_to_numpy,
)


def _nodes(kind, rng):
    if kind == "grid":  # regular plane samples: exact distance ties
        g = np.stack(np.meshgrid(np.arange(9), np.arange(7), indexing="ij"), -1).reshape(-1, 2)
        return np.concatenate([g * 0.05, np.ones((len(g), 1))], 1).astype(np.float32)
    return (rng.normal(size=(80, 3)) * [0.2, 0.2, 0.05] + [0, 0, 1]).astype(np.float32)


def _state(field) -> dict:
    return {
        f.name: (np.asarray(v) if hasattr(v, "shape") else v)
        for f in dataclasses.fields(field)
        for v in [getattr(field, f.name)]
    }


@pytest.mark.parametrize("kind", ["grid", "random"])
def test_build_matches(kind, rng):
    nodes = _nodes(kind, rng)
    kw = dict(node_coverage=0.05, layer_count=4, max_vertex_degree=4, anchor_count=4)
    jf = JH.build(nodes, coverage_method=JNC.FIXED, **kw)
    pf = PH.build(nodes, coverage_method=PNC.FIXED, device="cpu", **kw)
    assert pf.layer_node_counts == jf.layer_node_counts
    assert pf.layer_decimation_radii == jf.layer_decimation_radii
    assert pf.arrow_base == jf.arrow_base
    np.testing.assert_array_equal(pf.virtual_node_indices.numpy(), np.asarray(jf.virtual_node_indices))
    np.testing.assert_array_equal(pf.edges.numpy(), np.asarray(jf.edges))
    np.testing.assert_array_equal(pf.edge_layer_indices.numpy(), np.asarray(jf.edge_layer_indices))
    np.testing.assert_array_equal(
        pf.node_coverage_weights_squared.numpy(), np.asarray(jf.node_coverage_weights_squared)
    )


def test_virtual_updates_and_state_round_trip(rng):
    nodes = _nodes("random", rng)
    jf = JH.build(nodes, node_coverage=0.05, coverage_method=JNC.MINIMAL_K_NEIGHBOR_NODE_DISTANCE)
    pf = warp_field_from_numpy(_state(jf), device="cpu")
    np.testing.assert_array_equal(
        pf.node_coverage_weights_squared.numpy(),
        PH.build(nodes, node_coverage=0.05, device="cpu").node_coverage_weights_squared.numpy(),
    )
    delta = (0.05 * rng.normal(size=(jf.num_nodes, 6))).astype(np.float32)
    jf2 = jf.rotate_nodes_virtual(jnp.asarray(delta[:, :3])).translate_nodes_virtual(jnp.asarray(delta[:, 3:]))
    pf2 = pf.rotate_nodes_virtual(torch.as_tensor(delta[:, :3])).translate_nodes_virtual(torch.as_tensor(delta[:, 3:]))
    np.testing.assert_allclose(pf2.node_rotations.numpy(), np.asarray(jf2.node_rotations), atol=1e-6)
    np.testing.assert_allclose(pf2.node_translations.numpy(), np.asarray(jf2.node_translations), atol=1e-7)
    np.testing.assert_allclose(pf2.virtual_positions().numpy(), np.asarray(jf2.virtual_positions()))
    back = warp_field_to_numpy(pf2)
    assert back["coverage_method"] == "MINIMAL_K_NEIGHBOR_NODE_DISTANCE"
    assert back["layer_node_counts"] == jf.layer_node_counts
    np.testing.assert_array_equal(back["edges"], np.asarray(jf.edges))
