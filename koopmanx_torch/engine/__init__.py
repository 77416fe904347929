"""engine (see the package docstring)."""
from .local_linear import make_local_linear_loop
