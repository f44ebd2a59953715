"""One run of one cell: read the cell from ``BENCHMARK.json``, require the
card, hand the cell to its driver, check that no JAX module was loaded, and
print the result.

A driver (``drivers/<name>.py``, named by the traffic file's ``driver``)
has ``run(run: Run) -> dict`` with ``attempted``, ``failed``,
``end_to_end`` ({metric: value}), ``checks`` ({name: (value, limit)}),
``memory_peak_bytes`` and, for ``--trace 1``, ``trace`` (what the per-layer
readers read) and ``device_trace`` (``busy_s``, ``window_s``,
``breakdown``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that no run may load: JAX, and the JAX package
# and its benchmarks, which this benchmark does not measure
FORBIDDEN = ("jax", "jaxlib", "flax", "dynamicfuion_python_tpu", "benchmarks")
# the build and kernel caches of anything the run compiles, at fixed paths
# inside the checkout
CACHE = ROOT / ".portbench_cache"


class NoResult(Exception):
    """The run cannot give a result: it exits non-zero and prints none."""


@dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    t0: float
    device: str = "cuda"
    control: bool = False  # also run the reference in TF32 (control.py)
    scratch: Path | None = None  # the run's temporary directory, set by run_cell


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_bench(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise NoResult(f"no {path}")
    return json.loads(path.read_text())


def cell_files(bench: dict, workload: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration, traffic, limits) of ``workload``, each read
    from its own file by name."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "workloads" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text())
    return cell, config, traffic, limits


def metrics_of(bench: dict, kind: str, workload: str) -> list[dict]:
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def forbidden_loaded() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoResult("no CUDA device is available: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoResult(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi unavailable ({exc})"
    return f"card (name, power.limit): {out}"


def run_cell(run: Run) -> dict:
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        run.scratch = Path(tmp)
        return driver(run.traffic["driver"]).run(run)


def reader(name: str, root: Path = ROOT):
    """The per-layer metric ``name``'s reader, ``metrics/<name>.py``."""
    return load_module(root / "portbench" / "metrics" / f"{name}.py", f"portbench_metric_{name}")


def driver(name: str, root: Path = ROOT):
    """The driver ``drivers/<name>.py`` of an entry point."""
    return load_module(root / "portbench" / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def result_line(bench: dict, run: Run, outcome: dict, device_kind: str) -> dict:
    """The result's JSON object; the checks' numbers and limits last."""
    metrics = {}
    if run.trace:
        for m in metrics_of(bench, "per_layer", run.workload):
            value = reader(m["name"]).read(outcome["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, "end_to_end", run.workload):
            metrics[m["name"]] = {"value": outcome["end_to_end"][m["name"]], "unit": m["unit"]}
    checks = outcome["checks"]
    correct = bool(checks) and all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    device = {"platform": "gpu", "kind": device_kind, "count": run.cell["chips"],
              "memory_peak_bytes": int(outcome["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": outcome["attempted"], "failed": outcome["failed"],
            "metrics": metrics, "device": device}
    if run.trace:
        dt = outcome["device_trace"]
        device.update(busy_s=dt["busy_s"], window_s=dt["window_s"])
        line["breakdown"] = dt["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return line


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    try:
        bench = load_bench()
        cell, config, traffic, limits = cell_files(bench, args.workload)
        require_card(cell["chips"])
        import torch

        run = Run(args.workload, args.seed, args.seconds, bool(args.trace), cell, config, traffic, limits, t0)
        outcome = run_cell(run)
        print(card_line(), file=sys.stderr, flush=True)  # after the window: it takes host time
        found = forbidden_loaded()
        if found:
            raise NoResult(f"modules that no run may load were loaded: {found}")
        line = result_line(bench, run, outcome, torch.cuda.get_device_name(0))
    except NoResult as exc:
        print(f"portbench: {exc}", file=sys.stderr, flush=True)
        return 2
    # the numbers compared, each beside its limit, are the last lines on stderr
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
