"""Stateless tensor ops."""
