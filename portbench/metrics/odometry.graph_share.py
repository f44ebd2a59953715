"""Share of the rigid odometry's calls that replayed its CUDA graph, in %:
the port's counter ``odometry.graph_replays`` over it and ``odometry.eager``
(``ops/rigid_odometry.py``), over every call of the run. A port without
those counters has nothing to read."""

from portbench.program import port_counters


def read(trace):
    counters = port_counters() if trace.get("items") else None
    if not counters:
        return None
    replays = counters.get("odometry.graph_replays", 0)
    calls = replays + counters.get("odometry.eager", 0)
    return 100.0 * replays / calls if calls else None
