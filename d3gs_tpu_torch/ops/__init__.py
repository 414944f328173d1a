"""Kernels and tensor ops of the render path."""
