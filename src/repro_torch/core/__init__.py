"""Geometry helpers shared by the port's launch path."""
