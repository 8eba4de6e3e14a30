"""Mixed-precision policies and activation rematerialization."""
