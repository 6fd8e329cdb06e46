"""Artifact storage of the port."""
