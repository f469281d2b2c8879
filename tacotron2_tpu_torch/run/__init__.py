"""Drivers of the port (say)."""
