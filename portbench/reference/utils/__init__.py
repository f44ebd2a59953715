"""Configuration, device selection and state conversion."""
