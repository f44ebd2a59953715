"""Reference DeformNet and U²-Net checkpoints (port of
``dynamicfuion_python_tpu/models/torch_weight_conversion.py`` and of the
JAX ``models/u2net.py::convert_u2net_checkpoint``).

The port's networks carry the reference's module names, so a reference
``state_dict`` loads as it is: this module reads checkpoint files and names
the layers. ``LAYERS`` maps each reference layer to the JAX package's Flax
parameter path (the table of the JAX module's docstring), which
``utils/state_conversion.py`` uses to carry Flax parameters the other way.

A Flax msgpack checkpoint (the JAX package's parameter tree) is decoded by
``utils/flax_msgpack.py`` and carried to the port's names by
``utils/state_conversion.py::deform_net_state_from_jax``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

_WORDS = {1: "One", 2: "Two", 3: "Thr", 4: "Fou", 5: "Fiv", 6: "Six"}


def _layers() -> list[tuple[str, tuple, bool]]:
    """(reference layer name, Flax parameter path, is a transposed conv)."""
    out = []
    for level in range(6):
        for conv_idx, seq_idx in enumerate((0, 2, 4)):
            out.append((f"flow_net.moduleExtractor.module{_WORDS[level + 1]}.{seq_idx}",
                        ("flow_net", "Extractor_0", f"Conv_{3 * level + conv_idx}"), False))
    for level in range(2, 7):
        word, dec = _WORDS[level], ("flow_net", f"decoder{level}")
        if level != 6:
            out.append((f"flow_net.module{word}.moduleUpflow", (*dec, "ConvTranspose_0"), True))
            out.append((f"flow_net.module{word}.moduleUpfeat", (*dec, "ConvTranspose_1"), True))
        for conv_idx in range(5):
            out.append((f"flow_net.module{word}.module{_WORDS[conv_idx + 1]}.0", (*dec, f"Conv_{conv_idx}"), False))
        out.append((f"flow_net.module{word}.moduleSix.0", (*dec, "Conv_5"), False))
    for conv_idx, seq_idx in enumerate((0, 2, 4, 6, 8, 10, 12)):
        out.append((f"flow_net.moduleRefiner.moduleMain.{seq_idx}", ("flow_net", "refiner", f"Conv_{conv_idx}"), False))
    out.append(("mask_net.upconv1", ("mask_net", "ConvTranspose_0"), True))
    out.append(("mask_net.upconv2", ("mask_net", "ConvTranspose_1"), True))
    out.append(("mask_net.model.0.0.0", ("mask_net", "Conv_0"), False))
    for block in range(3):
        for which in range(2):
            out.append((f"mask_net.model.{block + 1}.block{which}.0",
                        ("mask_net", f"ResBlock_{block}", f"Conv_{which}"), False))
    out.append(("mask_net.model.4", ("mask_net", "Conv_1"), False))
    return out


LAYERS = _layers()


def load_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """A reference checkpoint (``.pt`` / ``.pth``, also wrapped as
    ``{"state_dict": ...}``, or ``.npz``) or a Flax msgpack parameter file
    (``.msgpack``) as {name: CPU tensor}."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            return {k: torch.as_tensor(data[k]) for k in data.files}
    if path.suffix == ".msgpack":
        from dynamicfuion_python_tpu_torch.utils import flax_msgpack
        from dynamicfuion_python_tpu_torch.utils.state_conversion import deform_net_state_from_jax

        return deform_net_state_from_jax(flax_msgpack.load(path))
    if path.suffix not in (".pt", ".pth"):
        raise ValueError(f"{path.name}: a DeformNet checkpoint is a .pt, .pth, .npz or Flax .msgpack file")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v.detach().cpu() for k, v in state.items()}


def load_deform_net_checkpoint(net: torch.nn.Module, path: str | Path) -> None:
    """Load a reference checkpoint into a DeformNet. A bare PWC-Net
    checkpoint (no ``flow_net.`` prefix) fills the flow net; when the file
    has no ``mask_net.`` layers the mask net keeps its own weights. Raises on
    missing flow-net layers, unexpected names and shape mismatches."""
    state = load_state_dict(path)
    if not any(k.startswith("flow_net.") for k in state):
        state = {f"flow_net.{k}": v for k, v in state.items()}
    missing, unexpected = net.load_state_dict(state, strict=False)
    has_mask = any(k.startswith("mask_net.") for k in state)
    missing = [k for k in missing if has_mask or not k.startswith("mask_net.")]
    if missing or unexpected:
        raise ValueError(f"checkpoint/model mismatch: missing={missing[:5]} unexpected={unexpected[:5]}")


# -- U²-Net ------------------------------------------------------------------


def u2net_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX package's U²-Net variables ``{"params": ..., "batch_stats":
    ...}`` (numpy leaves) as the original release's ``state_dict``: the
    inverse of the JAX ``convert_u2net_checkpoint``. Conv ``kernel``
    [kh, kw, in, out] -> ``weight`` [out, in, kh, kw]; BatchNorm ``scale`` ->
    ``weight``; batch stats ``mean`` / ``var`` -> ``running_mean`` /
    ``running_var``; ``num_batches_tracked`` is 0."""
    state: dict[str, torch.Tensor] = {}

    def walk(tree, prefix, stats):
        for key, value in tree.items():
            name = f"{prefix}{key}"
            if isinstance(value, dict):
                walk(value, name + ".", stats)
                continue
            value = np.asarray(value)
            if stats:
                state[f"{prefix}running_{key}"] = torch.as_tensor(value.copy())
                state[f"{prefix}num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
            elif key == "kernel":
                state[f"{prefix}weight"] = torch.as_tensor(value.transpose(3, 2, 0, 1).copy())
            elif key == "scale":
                state[f"{prefix}weight"] = torch.as_tensor(value.copy())
            elif key == "bias":
                state[name] = torch.as_tensor(value.copy())
            else:
                raise ValueError(f"unrecognized U²-Net variable: {name}")

    walk(variables["params"], "", False)
    walk(variables.get("batch_stats", {}), "", True)
    return state


def u2net_flax_from_state_dict(state_dict: dict) -> dict:
    """An original-release U²-Net ``state_dict`` as the JAX package's Flax
    variables (numpy leaves): the JAX ``convert_u2net_checkpoint`` mapping."""
    params: dict = {}
    batch_stats: dict = {}

    def put(tree, path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for name, tensor in state_dict.items():
        value = tensor.detach().cpu().numpy() if hasattr(tensor, "detach") else np.asarray(tensor)
        parts = name.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        if parts[-1] == "weight" and value.ndim == 4:
            put(params, parts[:-1] + ["kernel"], np.ascontiguousarray(value.transpose(2, 3, 1, 0)))
        elif parts[-1] == "weight":
            put(params, parts[:-1] + ["scale"], value)
        elif parts[-1] == "bias":
            put(params, parts, value)
        elif parts[-1] in ("running_mean", "running_var"):
            put(batch_stats, parts[:-1] + [parts[-1][len("running_"):]], value)
        else:
            raise ValueError(f"unrecognized checkpoint entry: {name}")
    return {"params": params, "batch_stats": batch_stats}


def load_u2net_checkpoint(model: torch.nn.Module, path: str | Path) -> None:
    """Load U²-Net weights into ``model`` (strict): an original-release
    ``.pth`` / ``.pt`` ``state_dict``, an ``.npz`` of Flax variables
    flattened with "/" (``params/stage1/rebnconvin/conv_s1/kernel``), or a
    Flax msgpack file of ``{"params": ..., "batch_stats": ...}``. Raises when
    the weights do not fit the configuration (U2NET for ``u2net.pth``,
    U2NETP for ``u2netp.pth``)."""
    path = Path(path)
    if path.suffix in (".pth", ".pt"):
        state = torch.load(path, map_location="cpu", weights_only=True)
    elif path.suffix == ".npz":
        tree: dict = {}
        with np.load(path, allow_pickle=False) as data:
            for key in data.files:
                node = tree
                *parents, leaf = key.split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[leaf] = data[key]
        state = u2net_state_dict_from_flax(tree)
    else:
        from dynamicfuion_python_tpu_torch.utils import flax_msgpack

        state = u2net_state_dict_from_flax(flax_msgpack.load(path))
    own = model.state_dict()
    wrong = [k for k, v in state.items() if k in own and tuple(own[k].shape) != tuple(v.shape)]
    if wrong:
        raise ValueError(
            f"checkpoint does not match the model configuration at {wrong[:3]} "
            "(use the full model for u2net.pth, the lite one for u2netp.pth)"
        )
    model.load_state_dict(state, strict=True)
