"""Launchers of the port (``src/repro/launch``): training and serving."""
