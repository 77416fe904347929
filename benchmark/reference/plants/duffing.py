"""The Duffing oscillator: x1' = x2, x2' = d x2 + k1 x1 + k3 x1^3 + u."""
import torch


def vector_field(x, u, th):
    x1, x2 = x[..., 0], x[..., 1]
    dx2 = th["d"] * x2 + th["k1"] * x1 + th["k3"] * x1 ** 3 + u[..., 0]
    return torch.stack([x2, dx2], dim=-1)
