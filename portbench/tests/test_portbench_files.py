"""The benchmark is driven by files found by name: every file that
``BENCHMARK.json`` names parses, and a cell, configuration, traffic mix,
limits and metric reader added as new files in a copy are found without an
edit to any file that is there."""

import json
import shutil

import pytest

from portbench import harness
from portbench.tests.helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    found, config, traffic, limits = harness.cell_files(BENCH, cell, ROOT)
    assert found["name"] == cell
    assert config["precision"].startswith("float32")
    assert (ROOT / "portbench" / "drivers" / f"{traffic['driver']}.py").is_file()
    assert limits and all(v > 0 for v in limits.values())
    assert harness.metrics_of(BENCH, "end_to_end", cell), "every cell reports end-to-end metrics"
    names = {m["name"] for m in harness.metrics_of(BENCH, "end_to_end", cell)}
    assert "setup_s" in names and len(names) >= 2
    assert harness.metrics_of(BENCH, "per_layer", cell)


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"] if c["traffic"].startswith("bend")])
def test_a_fusion_cell_takes_its_deployment_from_its_configuration(cell):
    """The pipeline's settings are the configuration's: the traffic file
    holds the scene and how the loop is driven over it, and nothing that
    sets the pipeline."""
    from portbench.reference.settings import Parameters
    from portbench.reference.utils.config import apply_overrides

    _, config, traffic, _ = harness.cell_files(BENCH, cell, ROOT)
    assert not {"overrides", "prior"} & set(traffic)
    entry = next(c for c in BENCH["configs"] if c["name"] == config["name"])
    changed = {o.split("=")[0] for o in config["overrides"]}
    assert changed == set(config["changed_from_source"]) == set(entry["reduced"])
    params = apply_overrides(Parameters(), list(config["overrides"]))
    assert params.fusion.use_neural_prior == ("flops" in config and "prior_forward" in config["flops"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    empty = {"busy_ms": 0.0, "launches": 0, "range_device_ms": {}, "untraced_ms": 1.0}
    assert harness.reader(metric, ROOT).read(empty) is None  # nothing to read: left out, never 0


@pytest.mark.parametrize("name", sorted(p.stem for p in (ROOT / "portbench" / "drivers").glob("[a-z]*.py")))
def test_each_driver_loads(name):
    assert callable(harness.driver(name, ROOT).run)


def test_a_new_cell_is_found_from_new_files_only(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    bench = dict(BENCH)
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    (pb / "configs" / "extra_config.json").write_text(json.dumps({"precision": "float32", "overrides": []}))
    (pb / "workloads" / "extra.json").write_text(json.dumps({"driver": "fusion", "image_size": [8, 8]}))
    (pb / "limits" / "extra.cell.json").write_text(json.dumps({"pose": 1.0}))
    (pb / "metrics" / "extra.metric.py").write_text("def read(trace):\n    return trace.get('extra')\n")
    bench["configs"] = [*BENCH["configs"], {"name": "extra_config", "file": "portbench/configs/extra_config.json"}]
    bench["workloads"] = [*BENCH["workloads"],
                          {"name": "extra.cell", "config": "extra_config", "traffic": "extra", "chips": 1}]
    bench["per_layer"] = [*BENCH["per_layer"], {"name": "extra.metric", "workloads": ["extra.cell"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, config, traffic, limits = harness.cell_files(harness.load_bench(tmp_path), "extra.cell", tmp_path)
    assert (cell["traffic"], config["precision"], traffic["driver"], limits) == ("extra", "float32", "fusion",
                                                                              {"pose": 1.0})
    assert harness.reader("extra.metric", tmp_path).read({"extra": 3.0}) == 3.0
    assert [m["name"] for m in harness.metrics_of(bench, "per_layer", "extra.cell")] == ["extra.metric"]
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items()), "no file that was there changed"
