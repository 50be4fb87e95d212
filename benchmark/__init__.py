"""The benchmark of the port (see README.md)."""
