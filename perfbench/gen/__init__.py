"""Frozen generators of the benchmark's inputs."""
