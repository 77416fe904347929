"""edmd (see the package docstring)."""
