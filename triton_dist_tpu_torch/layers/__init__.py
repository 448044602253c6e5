"""Layers of the port (world = 1)."""
