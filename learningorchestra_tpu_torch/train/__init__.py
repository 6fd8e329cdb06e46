"""Estimators of the port (inference subset; training comes later)."""
