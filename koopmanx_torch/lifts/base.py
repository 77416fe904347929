"""Lifting dictionaries psi: R^n -> R^N (counterpart of
``koopmanx/lifts/base.py``: the ``Dictionary`` wrapper,
``identity_dictionary`` at :78-80, ``constant_augmented`` at :83-96,
``state_augmented`` and ``zero_offset`` at :100-129, ``normalized`` and
``fit_normalizer`` at :132-162).

Where JAX held a pure apply function and a parameter pytree, the port
holds an ``nn.Module`` encoder and the normalizer as buffers, so ``.to()``
moves the whole lift.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor, nn


class Dictionary(nn.Module):
    """psi(x) = encoder(x), or (encoder(x) - mu) / sc when normalized.
    Maps (..., n) -> (..., nlift); ``decoder``, where given, maps back
    (:meth:`decode`, ``lifts/base.py:43-50``)."""

    def __init__(self, encoder: nn.Module, nlift: int, n: int,
                 mean: Optional[Tensor] = None,
                 scale: Optional[Tensor] = None,
                 decoder: Optional[nn.Module] = None):
        super().__init__()
        self.encoder = encoder
        self.nlift = nlift
        self.n = n
        self.register_buffer("mu", mean)
        self.register_buffer("sc", scale)
        self.decoder = decoder

    @property
    def is_normalized(self) -> bool:
        return self.mu is not None

    @property
    def has_decoder(self) -> bool:
        return self.decoder is not None

    def decode(self, z: Tensor) -> Tensor:
        """The decoder on a lifted state (..., nlift) -> (..., n)."""
        if self.decoder is None:
            raise ValueError("this dictionary has no decoder")
        return self.decoder(z)

    def forward(self, x: Tensor) -> Tensor:
        z = self.encoder(x)
        if self.mu is not None:
            z = (z - self.mu) / self.sc
        return z


class StateAugmented(nn.Module):
    """[x; inner(x)]."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, x: Tensor) -> Tensor:
        return torch.cat([x, self.inner(x)], dim=-1)


class ZeroOffset(nn.Module):
    """inner(x) - inner(0)."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, x: Tensor) -> Tensor:
        zero = torch.zeros(x.shape[-1:], dtype=x.dtype, device=x.device)
        return self.inner(x) - self.inner(zero)


class ConstantAugmented(nn.Module):
    """[x; 1]."""

    def forward(self, x: Tensor) -> Tensor:
        one = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        return torch.cat([x, one], dim=-1)


def identity_dictionary(n: int) -> Dictionary:
    """psi(x) = x (``Revise_2/Koopman_update.m:65``, a commented option)."""
    return Dictionary(nn.Identity(), nlift=n, n=n)


def constant_augmented(n: int) -> Dictionary:
    """psi(x) = [x; 1], the affine Koopman lift: an affine model
    x+ = A x + B u + d is exactly the linear model [[A, d], [0, 1]] on it
    (the local-linearization baseline, :mod:`..engine.local_linear`)."""
    return Dictionary(ConstantAugmented(), nlift=n + 1, n=n)


def zero_offset(inner: Dictionary) -> Dictionary:
    """psi(x) = inner(x) - inner(0)."""
    return Dictionary(ZeroOffset(inner), nlift=inner.nlift, n=inner.n)


def state_augmented(inner: Dictionary) -> Dictionary:
    """psi(x) = [x; inner(x)]. JAX's ``state_augmented(d, zero_offset=True)``
    (``Revise_2/Koopman_update.m:67``), [x; d(x)] - [0; d(0)], is
    ``state_augmented(zero_offset(d))``."""
    return Dictionary(StateAugmented(inner), nlift=inner.n + inner.nlift,
                      n=inner.n)


def normalized(inner: Dictionary, mean: Tensor, scale: Tensor) -> Dictionary:
    """psi'(x) = (psi(x) - mean) / scale: lifted-feature standardization,
    which keeps the square-root RLS accurate in float32; a decoder stays
    as it was."""
    if inner.is_normalized:
        raise ValueError("dictionary is already normalized")
    return Dictionary(inner.encoder, inner.nlift, inner.n, mean, scale,
                      decoder=inner.decoder)


def fit_normalizer(inner: Dictionary, x_samples: Tensor, eps: float = 1e-6
                   ) -> Tuple[Tensor, Tensor]:
    """(mean, scale) of the lifted features over training states; the
    population standard deviation, as ``jnp.std``."""
    z = inner(x_samples)
    mu = z.mean(dim=0)
    sc = torch.clamp(z.std(dim=0, correction=0), min=eps)
    return mu, sc
