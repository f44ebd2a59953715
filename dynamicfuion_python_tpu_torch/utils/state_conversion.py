"""Carry warp-field and TSDF-volume state, and DeformNet weights, between
the JAX package and the port.

The state is a dict of numpy arrays: the JAX objects' pytree leaves plus
their static fields, under the dataclass field names. This system has no
learned weights on the fusion path, so the warp field and the volume are its
parameters; the tests use these converters to start the port's fitter and
integrator from the exact state the JAX package holds. Enum fields travel as
their name. Nothing here imports JAX: the caller builds the dict, e.g.
``{f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}``.

DeformNet weights travel from the JAX package's Flax parameter tree (numpy
leaves) to the port's ``state_dict``: the inverse of the JAX package's
reference-checkpoint conversion.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.models.voxel_block_grid import VoxelBlockGrid
from dynamicfuion_python_tpu_torch.models.warp_field import (
    HierarchicalGraphWarpField,
    NodeCoverageMethod,
    WarpField,
)
from dynamicfuion_python_tpu_torch.utils.device import resolve_device

_INT_FIELDS = {"virtual_node_indices", "edges", "slot_keys", "sorted_keys", "slot_of_sorted"}


def deform_net_state_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX DeformNet's Flax parameters (``{"flow_net": ..., "mask_net":
    ...}``, optionally under ``"params"``, numpy leaves) as the port's
    ``state_dict``. Conv kernels HWIO -> [out, in, kh, kw]; transposed-conv
    kernels [kh, kw, in, out] -> [in, out, kh, kw], spatially flipped (Flax
    applies the kernel unflipped, torch's transposed conv is the conv's
    gradient)."""
    from dynamicfuion_python_tpu_torch.models.torch_weight_conversion import LAYERS

    params = params.get("params", params)
    state = {}
    for name, path, transposed in LAYERS:
        node = params
        for key in path:
            if key not in node:
                break
            node = node[key]
        else:
            kernel = np.asarray(node["kernel"])
            if transposed:
                weight = np.transpose(kernel, (2, 3, 0, 1))[:, :, ::-1, ::-1]
            else:
                weight = np.transpose(kernel, (3, 2, 0, 1))
            state[f"{name}.weight"] = torch.as_tensor(np.ascontiguousarray(weight))
            state[f"{name}.bias"] = torch.as_tensor(np.array(node["bias"]))
    return state


def _from_numpy(cls, state: dict, device):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in state:
            continue
        value = state[f.name]
        if f.name == "coverage_method":
            kwargs[f.name] = NodeCoverageMethod[getattr(value, "name", value)]
        elif f.name in ("layer_node_counts",):
            kwargs[f.name] = tuple(int(x) for x in np.asarray(value).reshape(-1))
        elif f.name in ("layer_decimation_radii",):
            kwargs[f.name] = tuple(float(x) for x in np.asarray(value).reshape(-1))
        elif isinstance(value, np.ndarray) and value.ndim > 0:
            dtype = torch.int32 if f.name in _INT_FIELDS else None
            if f.name == "edge_layer_indices":
                dtype = torch.int8
            kwargs[f.name] = torch.as_tensor(np.array(value), dtype=dtype, device=device)
        else:
            kwargs[f.name] = type(f.default)(np.asarray(value).item()) if f.default is not dataclasses.MISSING else value
    return cls(**kwargs)


def _to_numpy(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if isinstance(value, torch.Tensor):
            out[f.name] = value.detach().cpu().numpy()
        elif isinstance(value, NodeCoverageMethod):
            out[f.name] = value.name
        else:
            out[f.name] = value
    return out


def warp_field_from_numpy(state: dict, device: str | torch.device | None = None) -> WarpField:
    """A warp field on ``device`` (the CUDA card unless the caller passes
    ``device="cpu"``) from its arrays + static fields: a
    ``HierarchicalGraphWarpField`` when the state has its ``edges``, else a
    flat ``WarpField``."""
    cls = HierarchicalGraphWarpField if "edges" in state else WarpField
    return _from_numpy(cls, state, resolve_device(device))


def warp_field_to_numpy(field: WarpField) -> dict:
    return _to_numpy(field)


def voxel_block_grid_from_numpy(state: dict, device: str | torch.device | None = None) -> VoxelBlockGrid:
    """A ``VoxelBlockGrid`` on ``device`` (the CUDA card unless the caller
    passes ``device="cpu"``) from its arrays + static fields."""
    return _from_numpy(VoxelBlockGrid, state, resolve_device(device))


def voxel_block_grid_to_numpy(volume: VoxelBlockGrid) -> dict:
    return _to_numpy(volume)
