"""Device idle share of a training step: 1 - device busy time of the traced
steps (per step) over the median untraced step of the same run's window,
in %."""


def read(trace):
    if trace["busy_ms"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_ms"] / trace["untraced_ms"])
