"""Frame sequences."""
