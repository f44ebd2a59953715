"""DeformNet training steps on the card: how long they take and whether they
repeat bit for bit.

    python -m dynamicfuion_python_tpu_torch.apps.profile_train_step

Writes chip_smoke.py's training split (two 480x640 synthetic sequences, 4
pairs, closed-form flows) under a temporary directory, then runs
``train()`` at stage 1_solver at the JAX ``train()``'s defaults (448x640
crop, batch 4, 128 node slots, 10,000 matches, lr 1e-4) twice for 5 steps
each: per step the forward, backward, optimizer and whole-step ms (CUDA
events), and whether both runs leave the same weights. Then one 1_solver step and one 3_refine step at 192x256, batch 1,
from the first run's weights, each run twice: whether the loss and every
gradient repeat bit for bit, the largest difference, and the gradients
that differ. Prints the card's name and power limit, then one JSON line.

It calls only what the port has had since its training slice, so a copy of
it measures an older tree the same way.
"""

from __future__ import annotations

import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from dynamicfuion_python_tpu_torch.apps import create_graph_data, train
from dynamicfuion_python_tpu_torch.data.deform_dataset import LabeledDeformDataset
from dynamicfuion_python_tpu_torch.data.synthetic_pairs import write_split
from dynamicfuion_python_tpu_torch.models.deform_net import seeded_state_dict
from dynamicfuion_python_tpu_torch.settings import TrainingConfig

SPLIT_SIZE = (480, 640)
REPEAT_CROP = (192, 256)
STEPS = 5
RUNS = 2


def _step_gradients(stage: str, state: dict, batch: dict) -> tuple[float, dict]:
    """One SGD step of ``stage`` on the card from ``state`` (mask net seeded
    by 0 where ``state`` lacks it): (loss, {name: gradient on the CPU})."""
    model = train.build_model(train.STAGES[stage], 128, 10000)
    model.load_state_dict(seeded_state_dict(model, torch.Generator().manual_seed(0)))
    model.load_state_dict({k: v for k, v in state.items() if k in model.state_dict()}, strict=False)
    model.to("cuda")
    optimizer, scheduler = train._stage_optimizer(train.STAGES[stage], model, 1e-4, use_adam=False)
    loss, _ = train.make_train_step(model, optimizer, train.STAGES[stage], scheduler)(dict(batch))
    return float(loss), {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}


def compare_steps(first: tuple[float, dict], second: tuple[float, dict]) -> dict:
    """Two runs of a step, each (loss, {name: gradient}): whether the loss
    and every gradient are the same bits, the gradients that differ and
    the largest difference."""
    (loss_a, grads_a), (loss_b, grads_b) = first, second
    differ = sorted(k for k, g in grads_a.items() if not torch.equal(g.view(torch.uint8), grads_b[k].view(torch.uint8)))
    return {"loss_bit_equal": loss_a == loss_b, "gradients_bit_equal": not differ, "tensors": len(grads_a),
            "tensors_differing": len(differ), "differing": differ[:8],
            "grad_max_abs_diff": max(float((grads_b[k] - g).abs().max()) for k, g in grads_a.items())}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    row = {"steps": STEPS, "runs": []}
    cfg = TrainingConfig(shuffle=False)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for seq in write_split(root / "train", SPLIT_SIZE):
            create_graph_data.main([str(seq), "--frames", "0", "--labels", str(root / "train.json")])
        states = []
        for run in range(RUNS):
            stats: dict = {}
            model, losses = train.train(str(root), stage="1_solver", labeled=True, iterations=STEPS,
                                        learning_rate=1e-4, eval_every=0, checkpoint_dir=str(root / f"ckpt{run}"),
                                        training_config=cfg, stats=stats)
            states.append({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
            row["runs"].append({"losses": losses, **{k: stats[k] for k in
                                                     ("step_ms", "forward_ms", "backward_ms", "optimizer_ms")}})
            del model
        row["weights_bit_equal"] = all(
            all(torch.equal(s[k].view(torch.uint8), states[0][k].view(torch.uint8)) for k in states[0])
            for s in states[1:])
        dataset = LabeledDeformDataset(root, "train", input_size=REPEAT_CROP, max_nodes=128)
        batch = dataset.batch([0])
        batch["node_translations_gt"] = train.node_translations_gt_from_scene_flow(batch)[0]
        batch["match_subsample_uniforms"] = np.random.default_rng(1).uniform(
            size=batch["target"].shape[:3]).astype(np.float32)
        batch = train.batch_to_device(batch, "cuda")
        row["step_repeat"] = {stage: compare_steps(_step_gradients(stage, states[0], batch),
                                                   _step_gradients(stage, states[0], batch))
                              for stage in ("1_solver", "3_refine")}
    row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
