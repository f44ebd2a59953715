"""Kernel launches per frame: the traced frames' kernel rows (copies and
sets left out), per frame. The loop is host-paced; each launch costs host
time."""


def read(trace):
    return trace["launches"] or None
