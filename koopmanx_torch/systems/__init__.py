"""systems (see the package docstring)."""
