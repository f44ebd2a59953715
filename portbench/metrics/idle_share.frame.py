"""Device idle share of a frame: 1 - device busy time of the traced frames
(kernels, copies, sets; per frame) over the median untraced frame of the
same run's window, in %, so the profiler's own host cost does not count."""


def read(trace):
    if trace["busy_ms"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_ms"] / trace["untraced_ms"])
