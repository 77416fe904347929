"""lifts (see the package docstring)."""
