"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card; without one it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()  # set-up counts from here, before torch is imported

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # import the benchmark as ``portbench``, the port by its name
    from portbench import harness

    raise SystemExit(harness.main(sys.argv[1:], T0))
