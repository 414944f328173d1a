"""Gaussian state, renderer bridge and deformation fields."""
