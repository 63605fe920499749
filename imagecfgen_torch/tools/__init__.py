"""Measurement scripts of the port, run by path (see each module)."""
