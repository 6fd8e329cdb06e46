"""Estimator protocol and constructor registry of the port."""
