"""MLP encoder lift (counterpart of ``koopmanx/lifts/mlp.py:28-78``:
the MLP, its He init, the encoder lift and the autoencoder lift with the
reference's sizes).

ReLU between layers, linear final layer; weights in the ``(out, in)``
convention of the JAX package and the reference's ``.mat`` exports, which
is also ``nn.Linear``'s.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import Tensor, nn

from .base import Dictionary


class MLP(nn.Module):
    """ReLU MLP; x (..., in) -> (..., out)."""

    def __init__(self, sizes: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b, dtype=dtype) for a, b in zip(sizes[:-1], sizes[1:])
        )

    @classmethod
    def from_params(cls, params: List[Tuple[Tensor, Tensor]]) -> "MLP":
        """Build from ``[(W (out, in), b (out,)), ...]``."""
        sizes = [params[0][0].shape[1]] + [w.shape[0] for w, _ in params]
        mlp = cls(sizes, dtype=params[0][0].dtype)
        with torch.no_grad():
            for layer, (w, b) in zip(mlp.layers, params):
                layer.weight.copy_(torch.as_tensor(w))
                layer.bias.copy_(torch.as_tensor(b).reshape(-1))
        return mlp

    def params(self) -> List[Tuple[Tensor, Tensor]]:
        return [(layer.weight, layer.bias) for layer in self.layers]

    def forward(self, x: Tensor) -> Tensor:
        h = x
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return self.layers[-1](h)


def mlp_init(gen: torch.Generator, sizes: Sequence[int],
             dtype: torch.dtype = torch.float32) -> MLP:
    """He init: ``W ~ N(0, 2 / fan_in)``, ``b = 0`` (``lifts/mlp.py:37-51``),
    drawn from ``gen`` on the CPU."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        std = (2.0 / fan_in) ** 0.5
        w = std * torch.randn((fan_out, fan_in), generator=gen, dtype=dtype)
        params.append((w, torch.zeros((fan_out,), dtype=dtype)))
    return MLP.from_params(params)


def encoder_dictionary(mlp: MLP, n: int) -> Dictionary:
    return Dictionary(mlp, nlift=mlp.layers[-1].out_features, n=n)


def autoencoder_dictionary(encoder: MLP, decoder: MLP, n: int) -> Dictionary:
    """The encoder lift with the decoder attached
    (``Dictionary.decode``)."""
    return Dictionary(encoder, nlift=encoder.layers[-1].out_features, n=n,
                      decoder=decoder)


def reference_autoencoder_sizes(n: int = 2, nlift: int = 8, hidden: int = 100):
    """The reference autoencoder's layer widths (``duffing.py:21-38``):
    (encoder, decoder)."""
    enc = (n, hidden, hidden, hidden, nlift)
    dec = (nlift, hidden, hidden, hidden, n)
    return enc, dec
