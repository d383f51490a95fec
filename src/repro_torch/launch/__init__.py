"""Launchers of the port (``src/repro/launch``): the training driver."""
