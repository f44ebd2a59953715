"""Device-to-host reads per frame, the mean over every frame of the run:
the port's ``host_read.<site>`` counters (each a wait of the host for the
card) over its counter ``frames``; ``initialize``'s reads (the mesh counts,
the unique vertices) are in the sum too, 3 over the run's frames."""

from portbench.program import per_frame


def read(trace):
    return per_frame(trace, "host_read.")
