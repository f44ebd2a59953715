"""Device-to-host reads per SOD frame over every frame of the run: the
port's ``host_read.<site>`` counters (each a wait of the host for the
card; the loop's is ``host_read.sod.masks``, one a batch) over its counter
``sod.frames`` (masks written)."""


def read(trace):
    counters = trace.get("counters") or {}
    if not counters.get("sod.frames"):
        return None
    return sum(v for k, v in counters.items() if k.startswith("host_read.")) / counters["sod.frames"]
