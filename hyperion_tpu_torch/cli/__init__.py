"""Command-line entry points of the port."""
