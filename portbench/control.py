"""The readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds S]

For each seed, in one process: a run of the cell (a short window, the
sampled frames or the checked steps as a full run has them), its numbers
against the reference (the lower readings), and the control's: the
reference computed with TF32 on for cuBLAS and cuDNN, the precision below
the configurations' FP32, put in the port's place (the upper readings).
Prints one JSON line per seed. With ``--fault <name>`` it reads a fault
planted in the port (``faults.py``) instead of the control. The
benchmark's own runs do not run it.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    from portbench import harness
    from portbench.faults import planted

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None, help="read a fault planted in the port (faults.py) instead")
    args = ap.parse_args(argv)
    try:
        bench = harness.load_bench()
        cell, config, traffic, limits = harness.cell_files(bench, args.workload)
        harness.require_card(cell["chips"])
    except harness.NoResult as exc:
        print(f"control: {exc}", file=sys.stderr)
        return 2
    print(harness.card_line(), file=sys.stderr, flush=True)
    for seed in args.seeds:
        run = harness.Run(args.workload, seed, args.seconds, False, cell, config, traffic, limits,
                          time.perf_counter(), control=args.fault is None)
        with planted(args.fault) if args.fault else contextlib.nullcontext():
            out = harness.run_cell(run)
        row = {"seed": seed, args.fault or "program": {k: v for k, (v, _) in out["checks"].items()}}
        if args.fault is None:
            row["control"] = out["control"]
        print(json.dumps({**row, "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    raise SystemExit(main())
