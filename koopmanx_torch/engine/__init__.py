"""engine (see the package docstring)."""
