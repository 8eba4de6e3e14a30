"""Mixed-precision policies."""
