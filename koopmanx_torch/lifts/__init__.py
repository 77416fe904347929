"""lifts (see the package docstring)."""
from .base import constant_augmented
