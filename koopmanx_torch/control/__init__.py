"""control (see the package docstring)."""
