"""Deformation networks and fields."""
