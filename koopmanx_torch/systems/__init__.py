"""systems (see the package docstring)."""
from .linearize import (
    affine_residual,
    batch_linearize_discrete,
    linearize_continuous,
    linearize_discrete,
)
