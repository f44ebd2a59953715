"""Application entry points."""
