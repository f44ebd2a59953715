"""Drivers of the port's entry points, one file each, named by a traffic
file's ``driver``."""
