"""Warp fields, voxel block grid, fitter."""
