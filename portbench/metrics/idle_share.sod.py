"""Device idle share of a SOD frame: 1 - device busy time of the traced
batches (kernels, copies, sets; per frame) over the median untraced frame
(a batch's period in the window over its frames), in %, so the profiler's
own host cost does not count."""


def read(trace):
    if trace.get("busy_ms", 0.0) <= 0 or "span_device_ms" not in trace:
        return None
    return 100.0 * (1.0 - trace["busy_ms"] / trace["untraced_ms"])
