"""Offline rendering."""
