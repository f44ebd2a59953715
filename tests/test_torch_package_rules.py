"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package (the SOD app, U²-Net, the leaf ops and parallel/ included), its
entry points refuse to run without a card unless the caller asks for the
CPU, and what is not ported yet is refused by name."""

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


# float accumulations that order their additions by thread timing on the
# card: the package sums through ops/segment_sum.py only
ATOMIC_SUMS = ("index_add", "index_add_", "scatter_add", "scatter_add_")
SEGMENT_SUM = PORT / "ops" / "segment_sum.py"


def test_float_sums_go_through_segment_sum():
    """No ``index_add(_)``, ``scatter_add(_)`` or ``accumulate=True`` in the
    package outside ``ops/segment_sum.py``."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        if path == SEGMENT_SUM:
            continue
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Attribute) and node.attr in ATOMIC_SUMS:
                found.append(f"{path.relative_to(ROOT)}:{node.lineno} .{node.attr}")
            elif (isinstance(node, ast.keyword) and node.arg == "accumulate"
                  and not (isinstance(node.value, ast.Constant) and node.value.value is False)):
                found.append(f"{path.relative_to(ROOT)}:{node.lineno} accumulate=")
    assert not found, found


class _AtomicSumRecorder(torch.overrides.TorchFunctionMode):
    """Records each call of an accumulating scatter on a floating tensor
    with the innermost port file on the Python stack (``None``: no port
    frame)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        accumulate = kwargs.get("accumulate", args[3] if name in ("index_put", "index_put_") and len(args) > 3 else
                                args[2] if name == "put_" and len(args) > 2 else False)
        if (name in ATOMIC_SUMS or accumulate is True) and any(
                isinstance(a, torch.Tensor) and a.is_floating_point() for a in args):
            frame, where = sys._getframe(1), None
            while frame is not None and where is None:
                path = Path(frame.f_code.co_filename)
                if PORT in path.parents:
                    where = (path, frame.f_lineno)
                frame = frame.f_back
            self.calls.append((name, where))
        return func(*args, **kwargs)


def test_no_float_atomics_run_outside_segment_sum(tmp_path):
    """A 64x96 main-path frame and one prior frame (a seeded DeformNet at
    64x128) on the CPU: every accumulating scatter on a floating tensor is
    called from ``ops/segment_sum.py``."""
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.data.frame_sequence import SyntheticBendingPlaneSequence
    from dynamicfuion_python_tpu_torch.models.deform_net import DeformNet, seeded_state_dict
    from dynamicfuion_python_tpu_torch.settings import Parameters
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides

    small = ["tsdf.voxel_size=0.01", "tsdf.sdf_truncation_distance=0.04", "tsdf.initial_block_count=512",
             "graph.node_coverage=0.12", "graph.layer_count=2", "graph.erosion_num_iterations=1",
             "alignment.max_iteration_count=2", "fusion.far_clip_distance=2.0", "telemetry.print_runtime=false"]
    path = tmp_path / "deform_net.pt"
    torch.save(seeded_state_dict(DeformNet(), torch.Generator().manual_seed(0)), path)
    runs = (([], (64, 96), 120.0),
            (["fusion.use_neural_prior=true", f"fusion.prior_checkpoint={path}"], (64, 128), 90.0))
    recorder = _AtomicSumRecorder()
    for overrides, size, focal in runs:
        params = apply_overrides(Parameters(), small + overrides)
        seq = SyntheticBendingPlaneSequence(frame_count=2, image_size=size, bend_per_frame=0.02, focal=focal)
        f0, f1 = seq
        pipe = FusionPipeline(params, seq.intrinsics, device="cpu")
        pipe.initialize(f0.depth, f0.color)
        with recorder:
            pipe.process_frame(f1.depth, f1.color)
    outside = [(name, where) for name, where in recorder.calls if where is not None and where[0] != SEGMENT_SUM]
    assert not outside, outside
    # the recorder saw the package's sums: the data term, ARAP, the prior's
    assert sum(where is not None and where[0] == SEGMENT_SUM for _, where in recorder.calls) > 20


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

    from dynamicfuion_python_tpu_torch.apps import visualizer
    from dynamicfuion_python_tpu_torch.models.renderer import MeshRenderer
    from dynamicfuion_python_tpu_torch.ops.mesh_expand import ExpansionPlan

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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshRenderer((8, 8), k)
    assert MeshRenderer((8, 8), k, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visualizer.main(["--run", "."])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExpansionPlan(np.zeros((1, 3), np.int32), 3)


def test_sod_and_parallel_entry_points_need_a_card_unless_asked(monkeypatch, tmp_path):
    from dynamicfuion_python_tpu_torch import parallel
    from dynamicfuion_python_tpu_torch.apps import sod
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline
    from dynamicfuion_python_tpu_torch.settings import Parameters
    from dynamicfuion_python_tpu_torch.utils.telemetry import write_png

    (tmp_path / "color").mkdir()
    write_png(tmp_path / "color" / "000000.png", np.full((12, 10, 3), 90, np.uint8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sod.generate_masks(tmp_path / "color", tmp_path / "sod")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sod.main(["-i", str(tmp_path / "color")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sod.build_model()
    assert not (tmp_path / "sod").exists()  # refused before any work
    written = sod.generate_masks(tmp_path / "color", tmp_path / "sod", resize_to=(16, 16), device="cpu")
    assert [p.name for p in written] == ["000000.png"]
    # the parallel entry points: no rendezvous is attempted without a card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.initialize(f"file://{tmp_path / 'store'}", 1, 0, "gloo")
    assert not torch.distributed.is_initialized()
    for fn in (parallel.distributed_fit_step, parallel.distributed_fit_step_global):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(None, None, None, None, None, None, None, None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.global_rows_from_local(np.zeros((2, 2)), None)
    # the pipeline's device is its constructor's; enable_spmd names its group
    pipe = FusionPipeline(Parameters(), np.eye(3, dtype=np.float32), device="cpu")
    with pytest.raises(ValueError, match="process group"):
        pipe.enable_spmd(None)


def test_unported_options_are_refused(tmp_path):
    from dynamicfuion_python_tpu_torch.apps.fusion_pipeline import FusionPipeline, _load_prior_network
    from dynamicfuion_python_tpu_torch.data.frame_sequence import SyntheticBendingPlaneSequence
    from dynamicfuion_python_tpu_torch.settings import Parameters
    from dynamicfuion_python_tpu_torch.utils.config import apply_overrides
    from dynamicfuion_python_tpu_torch.utils.telemetry import TelemetryRecorder

    k = np.eye(3, dtype=np.float32)
    # the neural prior, the tracking spans and the other data terms run now
    for override in ("fusion.use_neural_prior=true", "fusion.tracking_span_mode=PREVIOUS_TO_CURRENT",
                     "fusion.tracking_span_mode=KEYFRAME_TO_CURRENT", "alignment.data_term_impl=fast",
                     "alignment.data_term_impl=autodiff", "fusion.pixel_anchor_computation_mode=SHORTEST_PATH"):
        FusionPipeline(apply_overrides(Parameters(), [override]), k, device="cpu")
    # a Flax msgpack prior checkpoint loads (the JAX DeformNet's parameter
    # tree; here seeded weights under their Flax paths), equal to Flax's
    import flax.serialization

    from dynamicfuion_python_tpu_torch.models.deform_net import DeformNet, seeded_state_dict
    from dynamicfuion_python_tpu_torch.models.torch_weight_conversion import LAYERS
    from dynamicfuion_python_tpu_torch.utils.state_conversion import deform_net_state_from_jax

    state = seeded_state_dict(DeformNet(), torch.Generator().manual_seed(4))
    tree: dict = {}
    for name, path, transposed in LAYERS:
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        weight = state[f"{name}.weight"].numpy()
        node["kernel"] = np.ascontiguousarray(
            weight[:, :, ::-1, ::-1].transpose(2, 3, 0, 1) if transposed else weight.transpose(2, 3, 1, 0))
        node["bias"] = state[f"{name}.bias"].numpy()
    (tmp_path / "deform_net.msgpack").write_bytes(flax.serialization.msgpack_serialize({"params": tree}))
    net = _load_prior_network(str(tmp_path / "deform_net.msgpack"), 4, "cpu")
    want = deform_net_state_from_jax(flax.serialization.msgpack_restore((tmp_path / "deform_net.msgpack").read_bytes()))
    for name, value in net.state_dict().items():
        assert torch.equal(value, want[name]) and torch.equal(value, state[name]), name
    pipe = FusionPipeline(Parameters(), k, device="cpu")  # the default configuration runs
    # the SPMD frame loop is ported: it asks for a process group, and for
    # initialize() to have run first
    with pytest.raises(ValueError, match="process group"):
        pipe.enable_spmd(None)
    with pytest.raises(RuntimeError, match="initialize"):
        pipe.enable_spmd(object())
    # so do the rendered source-image modes (the prior's source is the
    # rendered model) and the rendered-mesh recorder, built as run_fusion
    # builds it, on test_torch_entry_point.py's small bending plane
    small = ["tsdf.voxel_size=0.01", "tsdf.sdf_truncation_distance=0.04", "tsdf.initial_block_count=512",
             "graph.node_coverage=0.12", "graph.layer_count=2", "graph.erosion_num_iterations=1",
             "alignment.max_iteration_count=2", "fusion.far_clip_distance=2.0", "telemetry.print_runtime=false"]
    params = apply_overrides(Parameters(), small + [
        "fusion.use_neural_prior=true", "fusion.source_image_mode=RENDERED_WITH_PREVIOUS_FRAME_OVERLAY",
        "telemetry.record_rendered_warped_mesh=true", f"telemetry.output_directory={tmp_path}",
    ])
    seq = SyntheticBendingPlaneSequence(frame_count=2, image_size=(64, 96), bend_per_frame=0.02, focal=120.0)
    f0, f1 = seq
    pipe = FusionPipeline(params, seq.intrinsics, device="cpu")
    pipe.telemetry = TelemetryRecorder(params.telemetry, "rendered")
    pipe.initialize(f0.depth, f0.color)
    pipe.process_frame(f1.depth, f1.color, prior_flow=np.zeros((64, 96, 2), np.float32))
    assert {p.name for p in (tmp_path / "rendered").glob("*.png")} == {
        "000001_rendered_color.png", "000001_rendered_depth.png"}
    for mode in ("RENDERED_ONLY", "RENDERED_WITH_PREVIOUS_FRAME_OVERLAY"):
        pipe.params = apply_overrides(params, [f"fusion.source_image_mode={mode}"])
        source = pipe._prior_source_rgbxyz()
        assert source.shape == (64, 96, 6) and bool((source[..., 5] > 0).any())

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


BLOCKED = ("PIL", "msgpack", "yaml", "optax", "orbax", "flax", "jax", "cv2")
_BLOCKER = '''
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {blocked!r}


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{{name}} is not installed on the card machine")
        return None


sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
import dynamicfuion_python_tpu_torch
modules = [m.name for m in pkgutil.walk_packages(dynamicfuion_python_tpu_torch.__path__, "dynamicfuion_python_tpu_torch.")]
for name in modules:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (its phases import the port only)

from pathlib import Path
from dynamicfuion_python_tpu_torch.apps import create_graph_data, evaluate, generate, train
from dynamicfuion_python_tpu_torch.data.synthetic_pairs import write_split
from dynamicfuion_python_tpu_torch.settings import TrainingConfig

root = Path({tmp!r})
for seq in write_split(root / "train", (64, 128), pairs=((0, 1),)):
    create_graph_data.main([str(seq), "--node-coverage", "0.08", "--frames", "0", "--labels", str(root / "train.json")])
_, history = train.train(str(root), stage="1_solver", labeled=True, image_size=(64, 128), batch_size=1, iterations=1,
                         max_nodes=32, eval_every=1, checkpoint_dir=str(root / "ckpt"), device="cpu",
                         training_config=TrainingConfig(shuffle=False))
generate.generate(str(root), out_dir=str(root / "pred"), checkpoint_dir=str(root / "ckpt"), labels_filename="train",
                  image_size=(64, 128), max_nodes=32, device="cpu")
metrics = evaluate.evaluate(str(root), predictions_dir=str(root / "pred"), labels_filename="train",
                            image_size=(64, 128), max_nodes=32)
assert metrics["pair_count"] == 2 and metrics["epe_3d"] is not None, metrics
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("IMPORT_BLOCKER_OK", len(modules), history)
'''


def test_port_runs_without_the_packages_the_card_lacks(tmp_path):
    """The card machine has torch, numpy, scipy, einops and the standard
    library: with PIL, msgpack, yaml, optax, orbax, flax, jax and cv2
    refused at import, every port module and chip_smoke.py import, and a
    one-step CPU train() + generate + evaluate runs on a PNG split."""
    code = _BLOCKER.format(blocked=BLOCKED, root=str(ROOT), tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORT_BLOCKER_OK" in out.stdout


# backward nodes whose CUDA kernel adds into its gradient with float atomics
# (or, for cumsum, a scan whose association depends on thread timing), as
# PyTorch's determinism notes list them; the names are this PyTorch's
# (test_denied_backward_names_are_this_pytorchs). repeat_interleave's
# backward is IndexSelectBackward0 with tensor repeats, a view with an int
ATOMIC_BACKWARDS = {
    "IndexSelectBackward0": lambda x: torch.index_select(x, 0, torch.tensor([0, 0])),
    "GatherBackward0": lambda x: torch.gather(x, 0, torch.zeros((2, 4), dtype=torch.long)),
    "TakeBackward0": lambda x: torch.take(x, torch.tensor([0, 0])),
    "EmbeddingBackward0": lambda x: torch.nn.functional.embedding(torch.tensor([0, 0]), x),
    "EmbeddingBagBackward0": lambda x: torch.nn.functional.embedding_bag(
        torch.tensor([0, 0]), x, torch.tensor([0]), mode="max"),
    "CumsumBackward0": lambda x: torch.cumsum(x, 0),
    "UpsampleLinear1DBackward0": lambda x: torch.nn.functional.interpolate(x[None], size=8, mode="linear"),
    "UpsampleBilinear2DBackward0": lambda x: torch.nn.functional.interpolate(x[None, None], size=(8, 8), mode="bilinear"),
    "UpsampleBilinear2DAaBackward0": lambda x: torch.nn.functional.interpolate(
        x[None, None], size=(2, 2), mode="bilinear", antialias=True),
    "UpsampleBicubic2DBackward0": lambda x: torch.nn.functional.interpolate(x[None, None], size=(8, 8), mode="bicubic"),
    "UpsampleBicubic2DAaBackward0": lambda x: torch.nn.functional.interpolate(
        x[None, None], size=(2, 2), mode="bicubic", antialias=True),
    "UpsampleTrilinear3DBackward0": lambda x: torch.nn.functional.interpolate(
        x[None, None, None], size=(2, 8, 8), mode="trilinear"),
    "GridSampler2DBackward0": lambda x: torch.nn.functional.grid_sample(
        x[None, None], torch.zeros((1, 2, 2, 2)), align_corners=False),
    "GridSampler3DBackward0": lambda x: torch.nn.functional.grid_sample(
        x[None, None, None], torch.zeros((1, 1, 2, 2, 3)), align_corners=False),
    "AdaptiveAvgPool2DBackward0": lambda x: torch.nn.functional.adaptive_avg_pool2d(x[None], 3),
    "AdaptiveAvgPool3DBackward0": lambda x: torch.nn.functional.adaptive_avg_pool3d(x[None, None], 3),
    "AdaptiveMaxPool2DBackward0": lambda x: torch.nn.functional.adaptive_max_pool2d(x[None], 3),
    "AvgPool3DBackward0": lambda x: torch.nn.functional.avg_pool3d(x[None, None, None], (1, 2, 2)),
    "MaxPool3DWithIndicesBackward0": lambda x: torch.nn.functional.max_pool3d(x[None, None, None], (1, 2, 2)),
    "FractionalMaxPool2DBackward0": lambda x: torch.nn.functional.fractional_max_pool2d(
        x[None, None], 2, output_size=2, _random_samples=torch.full((1, 1, 2), 0.5)),
    "ReflectionPad1DBackward0": lambda x: torch.nn.functional.pad(x[None], (1, 1), mode="reflect"),
    "ReflectionPad2DBackward0": lambda x: torch.nn.functional.pad(x[None], (1, 1, 1, 1), mode="reflect"),
    "ReplicationPad1DBackward0": lambda x: torch.nn.functional.pad(x[None], (1, 1), mode="replicate"),
    "ReplicationPad2DBackward0": lambda x: torch.nn.functional.pad(x[None], (1, 1, 1, 1), mode="replicate"),
    "NllLossBackward0": lambda x: torch.nn.functional.nll_loss(x, torch.tensor([0, 1, 2, 3])),
}
# the fixed-order backwards of the training path (ops/warp.py::gather_rows,
# models/pwcnet.py::bilinear_resize, ops/segment_sum.py)
FIXED_ORDER_BACKWARDS = ("_GatherRowsBackward", "_BilinearResizeBackward", "_SegmentSumBackward")


@pytest.mark.parametrize("name", sorted(ATOMIC_BACKWARDS))
def test_denied_backward_names_are_this_pytorchs(name):
    x = torch.randn((4, 4), generator=torch.Generator().manual_seed(0), requires_grad=True)
    assert ATOMIC_BACKWARDS[name](x).grad_fn.name() == name


@pytest.fixture(scope="module")
def training_split(tmp_path_factory):
    """The 64x128 labeled split of tests/test_torch_training.py (four pairs,
    graphs at node coverage 0.08) and its first pair as a batch."""
    from dynamicfuion_python_tpu_torch.apps import create_graph_data, train
    from dynamicfuion_python_tpu_torch.data.deform_dataset import LabeledDeformDataset
    from dynamicfuion_python_tpu_torch.data.synthetic_pairs import write_split

    root = tmp_path_factory.mktemp("split")
    for seq in write_split(root / "train", (64, 128)):
        create_graph_data.main([str(seq), "--node-coverage", "0.08", "--frames", "0", "--labels", str(root / "train.json")])
    batch = LabeledDeformDataset(root, "train", input_size=(64, 128), max_nodes=32).batch([0])
    batch["node_translations_gt"] = train.node_translations_gt_from_scene_flow(batch)[0]
    batch["match_subsample_uniforms"] = np.random.default_rng(2).uniform(size=batch["target"].shape[:3]).astype(np.float32)
    return batch


@pytest.mark.parametrize("stage", ["1_solver", "3_refine"])
def test_training_backward_has_a_fixed_order(training_split, stage):
    """One training step's loss on the CPU at 64x128, batch 1, 32 nodes:
    no backward node of its graph adds with float atomics on the card, and
    the fixed-order gathers and upsampling stand in their place."""
    from dynamicfuion_python_tpu_torch.apps import train
    from dynamicfuion_python_tpu_torch.models.deform_net import seeded_state_dict

    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model = train.build_model(train.STAGES[stage], 32, 1000)
        model.load_state_dict(seeded_state_dict(model, torch.Generator().manual_seed(0)))
        train._stage_optimizer(train.STAGES[stage], model, 1e-4, use_adam=False)  # freezes as the stage does
        with train.fp32_step():
            loss, _ = train._forward_and_loss(model, train.batch_to_device(training_split, "cpu"), train.STAGES[stage])
        census = train.backward_census(loss)
    finally:
        torch.set_num_threads(previous)
    denied = {name: count for name, count in census.items() if name in ATOMIC_BACKWARDS}
    assert not denied, denied
    assert all(census.get(name, 0) > 0 for name in FIXED_ORDER_BACKWARDS), census
    assert census["ConvolutionBackward0"] > 50 and census["torch::autograd::AccumulateGrad"] > 100, census
