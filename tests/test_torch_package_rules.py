"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points refuse to run without a card unless the
caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dynamicfuion_python_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "dynamicfuion_python_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.models.voxel_block_grid import VoxelBlockGrid
    from dynamicfuion_python_tpu_torch.models.warp_field import HierarchicalGraphWarpField
    from dynamicfuion_python_tpu_torch.settings import Parameters
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides
    from dynamicfuion_python_tpu_torch.utils.state_conversion import (
        warp_field_from_numpy,
        warp_field_to_numpy,
    )

    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import main, run_fusion
    from dynamicfuion_python_tpu_torch.data.frame_sequence import SyntheticBendingPlaneSequence

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = Parameters()  # the default configuration, rigid odometry on
    k = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusionPipeline(params, k)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fusion(SyntheticBendingPlaneSequence(frame_count=2, image_size=(16, 16)), params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--frames", "2", "--size", "16x16"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VoxelBlockGrid.create(capacity=8)
    nodes = np.asarray([[0.0, 0.0, 1.0], [0.1, 0.0, 1.0]], np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HierarchicalGraphWarpField.build(nodes, layer_count=1)
    field = HierarchicalGraphWarpField.build(nodes, layer_count=1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warp_field_from_numpy(warp_field_to_numpy(field))
    assert warp_field_from_numpy(warp_field_to_numpy(field), device="cpu").device.type == "cpu"
    assert FusionPipeline(params, k, device="cpu").device.type == "cpu"


def test_unported_options_are_refused(tmp_path):
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline, _load_prior_network, run_fusion
    from dynamicfuion_python_tpu_torch.data.frame_sequence import SyntheticBendingPlaneSequence
    from dynamicfuion_python_tpu_torch.settings import Parameters
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

    k = np.eye(3, dtype=np.float32)
    # the neural prior, the tracking spans and the other data terms run now
    for override in ("fusion.use_neural_prior=true", "fusion.tracking_span_mode=PREVIOUS_TO_CURRENT",
                     "fusion.tracking_span_mode=KEYFRAME_TO_CURRENT", "alignment.data_term_impl=fast",
                     "alignment.data_term_impl=autodiff", "fusion.pixel_anchor_computation_mode=SHORTEST_PATH"):
        FusionPipeline(apply_overrides(Parameters(), [override]), k, device="cpu")
    for mode in ("RENDERED_ONLY", "RENDERED_WITH_PREVIOUS_FRAME_OVERLAY"):
        with pytest.raises(NotImplementedError, match="A10"):
            FusionPipeline(apply_overrides(Parameters(), [
                "fusion.use_neural_prior=true", f"fusion.source_image_mode={mode}",
            ]), k, device="cpu")
    with pytest.raises(NotImplementedError, match="msgpack"):
        _load_prior_network(str(tmp_path / "deform_net.msgpack"), 4, "cpu")
    pipe = FusionPipeline(Parameters(), k, device="cpu")  # the default configuration runs
    with pytest.raises(NotImplementedError, match="A17"):
        pipe.enable_spmd(None)
    params = apply_overrides(Parameters(), [
        "telemetry.record_rendered_warped_mesh=true", f"telemetry.output_directory={tmp_path}",
    ])
    with pytest.raises(NotImplementedError, match="A10"):
        run_fusion(SyntheticBendingPlaneSequence(frame_count=2, image_size=(16, 16)), params, device="cpu")


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:  # alone, without the rest of the repository
            script = tmp_path / "chip_smoke.py"
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_settings_match_the_jax_package():
    from dynamicfuion_python_tpu.settings import Parameters as JParams
    from dynamicfuion_python_tpu.utils.config import apply_overrides as j_apply, to_dict as j_dict
    from dynamicfuion_python_tpu_torch.settings import Parameters as PParams
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides as p_apply, to_dict as p_dict

    assert p_dict(PParams()) == j_dict(JParams())
    overrides = ["tsdf.voxel_size=0.01", "alignment.iteration_modes=translation_only,all",
                 "fusion.graph_generation_mode=FIRST_FRAME_DEPTH_IMAGE", "alignment.use_rigid_alignment=false"]
    assert p_dict(p_apply(PParams(), overrides)) == j_dict(j_apply(JParams(), overrides))
    with pytest.raises(KeyError):
        p_apply(PParams(), ["tsdf.no_such_key=1"])
