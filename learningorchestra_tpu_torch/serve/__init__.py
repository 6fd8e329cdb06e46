"""Resident model serving of the port: registry, micro-batcher, service."""
