"""Polynomial dictionaries: tensor-product Hermite and monomials
(counterpart of ``koopmanx/lifts/poly.py``).

The training file builds a 25-function tensor-product Hermite dictionary
over (x1, x2) (``DeepLearning_KoopmanControl_Approach3.py:207-224``); the
monomial lift [x; x1 x2; x1 x2^2; x1^2 x2] is the commented option at
``Revise_2/Koopman_update.m:66``. The reference's recurrence has
``H0(x) = 2x + 2`` (its ``Hermite(0, x)`` falls through to the generic
branch); ``reference_quirk=True`` reproduces that, the default is the
standard physicists' ``H0 = 1``.
"""
from __future__ import annotations

from typing import List

import torch
from torch import Tensor, nn

from .base import Dictionary


def hermite_sequence(x: Tensor, degree: int,
                     reference_quirk: bool = False) -> List[Tensor]:
    """[H0(x), ..., H_degree(x)] (physicists' Hermite)."""
    if reference_quirk:
        # seeds H_{-1} = H_{-2} = 1, so H0 = 2x + 2; H1 = 2x; then the
        # recurrence
        hm2 = hm1 = torch.ones_like(x)
        seq = []
        for k in range(degree + 1):
            h = 2.0 * x if k == 1 else 2.0 * x * hm1 - 2.0 * (k - 1) * hm2
            seq.append(h)
            hm2, hm1 = hm1, h
        return seq
    seq = [torch.ones_like(x)]
    if degree >= 1:
        seq.append(2.0 * x)
    for k in range(2, degree + 1):
        seq.append(2.0 * x * seq[-1] - 2.0 * (k - 1) * seq[-2])
    return seq


class Hermite(nn.Module):
    """H_i(x1) H_j(x2) for i, j in 0..degree, j outer and i inner (the
    reference's order); (..., 2) -> (..., (degree + 1)^2)."""

    def __init__(self, degree: int, reference_quirk: bool = False):
        super().__init__()
        self.degree = degree
        self.reference_quirk = reference_quirk

    def forward(self, x: Tensor) -> Tensor:
        d = self.degree
        hx = hermite_sequence(x[..., 0], d, self.reference_quirk)
        hy = hermite_sequence(x[..., 1], d, self.reference_quirk)
        return torch.stack([hx[i] * hy[j] for j in range(d + 1)
                            for i in range(d + 1)], dim=-1)


class Monomial(nn.Module):
    """[x1, x2, x1 x2, x1 x2^2, x1^2 x2]; (..., 2) -> (..., 5)."""

    def forward(self, x: Tensor) -> Tensor:
        x1, x2 = x[..., 0], x[..., 1]
        return torch.stack([x1, x2, x1 * x2, x1 * (x2 * x2), (x1 * x1) * x2],
                           dim=-1)


def hermite_dictionary(degree: int = 4,
                       reference_quirk: bool = False) -> Dictionary:
    """The tensor-product Hermite dictionary over 2-D states: (degree+1)^2
    functions (DeepLearning_KoopmanControl_Approach3.py:215-224)."""
    return Dictionary(Hermite(degree, reference_quirk),
                      nlift=(degree + 1) ** 2, n=2)


def monomial_dictionary() -> Dictionary:
    """psi(x) = [x1, x2, x1 x2, x1 x2^2, x1^2 x2]
    (Revise_2/Koopman_update.m:66, a commented option)."""
    return Dictionary(Monomial(), nlift=5, n=2)
