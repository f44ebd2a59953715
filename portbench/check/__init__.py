"""The comparison that decides ``correct``: the port's outputs against the
plain reference (``portbench/reference``), number by number, each beside
its limit (``portbench/limits/<cell>.json``)."""
