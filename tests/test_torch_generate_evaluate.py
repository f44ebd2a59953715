"""The port's generate -> evaluate against the JAX package's on the CPU: the
same weights (JAX-initialized, carried by a training checkpoint of the port)
on a synthetic 128x192 split with graphs built from the source depth; the
metrics within 1e-4 (metres; the ratio exact). Also the alignment demo's
artifacts."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfuion_python_tpu_torch.utils.state_conversion import deform_net_state_from_jax


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads per test: the CPU suite runs several test files
    at once, and eight spinning threads per file oversubscribe the cores."""
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def params():
    """DeformNet's Flax parameters, its two networks initialized apart and
    jitted (the eager init of the whole module takes minutes on the CPU)."""
    from dynamicfuion_python_tpu.models.mask_net import MaskNet
    from dynamicfuion_python_tpu.models.pwcnet import PWCNet

    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    x = jnp.zeros((1, 64, 64, 3))
    flow_net = jax.jit(PWCNet().init)(k1, x, x)["params"]
    mask_net = jax.jit(MaskNet().init)(k2, jnp.zeros((1, 16, 16, 565)), jnp.zeros((1, 64, 64, 12)))["params"]
    return jax.tree_util.tree_map(np.asarray, {"params": {"flow_net": flow_net, "mask_net": mask_net}})


def test_generate_then_evaluate_matches_jax(tmp_path, params, monkeypatch):
    from dynamicfuion_python_tpu.apps import evaluate as JE
    from dynamicfuion_python_tpu.apps import generate as JGen
    from dynamicfuion_python_tpu.models.deform_net import DeformNet as JaxDeformNet
    from dynamicfuion_python_tpu_torch.apps import evaluate as PE
    from dynamicfuion_python_tpu_torch.apps import generate as PGen
    from dynamicfuion_python_tpu_torch.apps.train import save_checkpoint
    from dynamicfuion_python_tpu_torch.data.synthetic_pairs import write_split
    from dynamicfuion_python_tpu_torch.models.deform_net import DeformNet

    write_split(tmp_path / "train", (128, 192), pairs=((0, 2),))

    class GivenWeights(JaxDeformNet):
        def init(self, *args, **kwargs):  # the JAX generate's eager init, replaced by the fixture's weights
            return jax.tree_util.tree_map(jnp.asarray, params)

    monkeypatch.setattr(JGen, "DeformNet", GivenWeights)
    kwargs = dict(max_nodes=96, node_coverage=0.05)
    JGen.generate(str(tmp_path), split="train", out_dir=str(tmp_path / "jax_pred"), **kwargs)
    want = JE.evaluate(str(tmp_path), split="train", predictions_dir=str(tmp_path / "jax_pred"), **kwargs)

    model = DeformNet(use_mask=True)
    model.load_state_dict(deform_net_state_from_jax(params))
    save_checkpoint(tmp_path / "ckpt", model, 0)
    index = PGen.generate(str(tmp_path), out_dir=str(tmp_path / "port_pred"), checkpoint_dir=str(tmp_path / "ckpt"),
                          device="cpu", **kwargs)
    got = PE.evaluate(str(tmp_path), predictions_dir=str(tmp_path / "port_pred"), **kwargs)

    assert index == json.loads((tmp_path / "jax_pred" / "index.json").read_text())
    assert got["pair_count"] == want["pair_count"] == 2
    assert want["valid_solve_ratio"] > 0 and want["graph_error_3d"] is not None
    # within 1e-4 (metres): the GN solve in f32 moves nodes by a few 1e-5
    # between the packages (2.4e-5 on the graph error here)
    for key in ("graph_error_3d", "epe_3d", "valid_solve_ratio"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4)
    for name in index:
        g, w = np.load(tmp_path / "port_pred" / f"{name}.npz"), np.load(tmp_path / "jax_pred" / f"{name}.npz")
        assert sorted(g.files) == sorted(w.files)
        np.testing.assert_array_equal(g["valid_solve"], w["valid_solve"])
        np.testing.assert_array_equal(g["deformations_validity"], w["deformations_validity"])
        assert g["deformed_points"].shape == w["deformed_points"].shape


def test_alignment_demo_writes_its_artifacts(tmp_path):
    from dynamicfuion_python_tpu_torch.apps.example_viz import main, run_alignment_demo, synthetic_pair
    from dynamicfuion_python_tpu_torch.utils.telemetry import read_ply, read_png

    summary = run_alignment_demo(synthetic_pair(), tmp_path / "demo", device="cpu")
    assert summary["artifacts"] == ["correspondences.npz", "deformed_points.ply", "mask_pred.png",
                                    "node_transforms.npz", "source_points.ply", "target_points.ply"]
    assert np.isfinite(summary["mean_translation"])
    assert read_png(tmp_path / "demo" / "mask_pred.png").shape == (64, 64)
    verts, faces = read_ply(tmp_path / "demo" / "deformed_points.ply")
    assert verts.shape == (64 * 64, 3) and faces.shape == (0, 3)
    with np.load(tmp_path / "demo" / "node_transforms.npz") as data:
        assert data["rotations"].shape == (9, 3, 3)
    assert main(["--synthetic", "--device", "cpu", "-o", str(tmp_path / "cli")]) == 0
    assert (tmp_path / "cli" / "node_transforms.npz").is_file()
