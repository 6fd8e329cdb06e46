"""REST front of the port."""
