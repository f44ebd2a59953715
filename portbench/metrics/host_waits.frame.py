"""Waits of the host for the card per frame, the mean over every frame of
the run: the port's ``host_read.<site>`` counters (a read of a value back)
and ``host_write.<site>`` counters (a copy from pageable host memory, which
waits for the stream as a read does) over its counter ``frames``;
``initialize``'s waits are in the sum too."""

from portbench.program import per_frame


def read(trace):
    return per_frame(trace, ("host_read.", "host_write."))
