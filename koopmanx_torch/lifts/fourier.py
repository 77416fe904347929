"""Random Fourier feature dictionary (counterpart of
``koopmanx/lifts/fourier.py``): psi(x) = sqrt(2/D) cos(x W' + b).

The rows of W are drawn N(0, diag(1 / (bandwidth * scale)^2)) and b ~
U[0, 2 pi) (Rahimi-Recht random features of the Gaussian kernel). The map
is one (n -> D) matmul and an elementwise cosine, and composes with the
state-augmentation and normalization wrappers of ``lifts/base.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from .base import Dictionary

__all__ = ["RFF", "rff_init", "fourier_dictionary"]


class RFF(nn.Module):
    """x (..., n) -> (..., D) random Fourier features of ``w`` (D, n) and
    ``b`` (D,), both held as buffers."""

    def __init__(self, w: Tensor, b: Tensor):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b)

    def forward(self, x: Tensor) -> Tensor:
        scale = math.sqrt(2.0 / self.w.shape[0])
        return scale * torch.cos(x @ self.w.transpose(-1, -2) + self.b)


def rff_init(gen: torch.Generator, n: int, nlift: int, bandwidth: float = 1.0,
             feature_scale: Optional[Tensor] = None,
             dtype: torch.dtype = torch.float32) -> Tuple[Tensor, Tensor]:
    """Draw ``w`` (nlift, n) ~ N(0, 1) / bandwidth / feature_scale and
    ``b`` (nlift,) ~ U[0, 2 pi) from ``gen``. ``feature_scale`` (n,), the
    training states' per-dimension std, puts the bandwidth in data units."""
    w = torch.randn((nlift, n), generator=gen, dtype=dtype) / bandwidth
    if feature_scale is not None:
        w = w / feature_scale.to(dtype)[None, :]
    b = torch.rand((nlift,), generator=gen, dtype=dtype) * (2.0 * math.pi)
    return w, b


def fourier_dictionary(w: Tensor, b: Tensor) -> Dictionary:
    return Dictionary(RFF(w, b), nlift=w.shape[0], n=w.shape[1])
