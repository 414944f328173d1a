"""Readers, cameras, scenes and file formats."""
