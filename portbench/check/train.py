"""The training step's comparison: the port's first three steps against the
reference's from the same weights, batches and match uniforms.

Numbers compared (each relative, the worst case):
  - ``loss``: each step's loss against the reference's;
  - ``grad``: by leaf, the gap between the norms of the first gradient as
    the optimizer got it (SGD's momentum buffer after one step, which is
    the gradient) over the larger of the reference's norm of that leaf and
    of the median leaf;
  - ``change``: by leaf, the same of the parameters' change over the three
    steps, read before the fourth; leaves whose reference gradient is under
    a thousandth of the median leaf's move by round-off alone and are left
    out.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.check.precision import precision

NAMES = ("loss", "grad", "change")
NOUGHT = 1e-3  # a leaf's gradient under this share of the median leaf's is nought to rounding


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def gaps(program: dict, reference: dict) -> dict:
    """``program`` / ``reference``: {"losses": [3 floats], "grad": {leaf:
    norm}, "change": {leaf: norm}}."""
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program["losses"], reference["losses"])]
    out = {"loss": max(losses) if len(program["losses"]) == len(reference["losses"]) else np.inf}
    g_ref = reference["grad"]
    g_median = float(np.median(list(g_ref.values())))
    out["grad"] = max(abs(program["grad"].get(k, np.inf) - v) / max(v, g_median) for k, v in g_ref.items())
    moved = {k: v for k, v in reference["change"].items() if g_ref.get(k, 0.0) >= NOUGHT * g_median}
    c_median = float(np.median(list(moved.values())))
    out["change"] = max(abs(program["change"].get(k, np.inf) - v) / max(v, c_median) for k, v in moved.items())
    out["leaves"] = (len(moved), len(reference["change"]))
    return out


def run_steps(model, optimizer, step, batches, initial: dict) -> dict:
    """Drive ``step`` over ``batches`` from ``initial`` weights (already in
    ``model``): the losses, the first gradient's leaf norms (from the
    optimizer's state after step one) and the change's leaf norms."""
    named = dict(model.named_parameters())
    losses, grad = [], None
    for i, batch in enumerate(batches):
        loss, _ = step(batch)
        losses.append(float(loss))
        if i == 0:
            grad = leaf_norms({k: optimizer.state[p]["momentum_buffer"] for k, p in named.items()
                               if p in optimizer.state})
    change = leaf_norms({k: p.detach() - initial[k].to(p.device) for k, p in named.items()})
    return {"losses": losses, "grad": grad, "change": change}


def reference_steps(config: dict, state: dict, split_root, rows: list, uniforms: list, device,
                    tf32: bool = False) -> dict:
    """The reference's first steps on the same rows and uniforms."""
    from portbench.reference.apps import train
    from portbench.reference.data.deform_dataset import LabeledDeformDataset

    stage = train.STAGES[config["stage"]]
    dataset = LabeledDeformDataset(split_root, "train", input_size=tuple(config["input_size"]),
                                   max_nodes=config["max_nodes"])
    model = train.build_model(stage, config["max_nodes"], config["gn_max_matches"])
    model.load_state_dict(state)
    model.to(device).train()
    optimizer = torch.optim.SGD(model.parameters(), lr=config["learning_rate"], momentum=config["momentum"],
                                dampening=0.0)
    step = train.make_train_step(model, optimizer, stage)
    batches = []
    for idx, u in zip(rows, uniforms):
        b = dataset.batch(idx)
        b["node_translations_gt"] = train.node_translations_gt_from_scene_flow(b)[0]
        b["match_subsample_uniforms"] = u
        batches.append(train.batch_to_device(b, device))
    with precision(tf32):
        return run_steps(model, optimizer, step, batches, state)
