"""The port's benchmark: one command runs one cell once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cells. Each cell's
configuration (``configs/<name>.json``), traffic mix
(``workloads/<name>.json``), the driver of its entry point
(``drivers/<name>.py``) and each per-layer metric's reader
(``metrics/<name>.py``) are files of their own, found by name. The plain
reference that decides ``correct`` is ``reference/``, a frozen copy of the
port's plain paths; ``check/`` compares with it.
"""
