"""Per-layer metric readers, one file each, named after the metric:
``read(trace: dict) -> float | None``, None where the traced run has
nothing to read (the harness then leaves the metric out)."""
