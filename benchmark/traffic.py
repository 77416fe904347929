"""The scenario generator every traffic mix feeds: a frozen copy of the
draw of ``koopmanx_torch/bench.py::bench_workload`` (with
``engine/scenario.py::sample_scenarios``): x0 ~ U[x0_range]^n, then each
plant parameter before the switch, then each after it, every one
``nominal * (1 + U[-param_scale, param_scale])`` per scenario, in the
order the plant lists them.

Episode ``e`` of a run with seed ``s`` draws on ``device`` from a
generator seeded with :func:`episode_seed`, so the same seed gives the
same scenarios, and every seed the same sizes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import Tensor

_MIX = 0x9E3779B97F4A7C15  # 2^64 / golden ratio: spreads nearby seeds
_MASK = (1 << 63) - 1


def episode_seed(seed: int, episode: int) -> int:
    """A 63-bit generator seed for episode ``episode`` of seed ``seed``
    (any whole number, negative or wider than 32 bits included)."""
    return ((seed * _MIX) ^ (episode * 0xBF58476D1CE4E5B9) ^ 0xD1B54A32D192ED03) & _MASK


def draw(plant: dict, traffic: dict, batch: int, seed: int, episode: int,
         dtype: torch.dtype, device) -> Tuple[Tensor, Dict[str, Tensor],
                                              Dict[str, Tensor]]:
    """One episode's scenarios: x0 (batch, n) and the parameters before and
    after the switch, each a dict of (batch,) tensors."""
    gen = torch.Generator(device=device).manual_seed(episode_seed(seed, episode))
    kw = dict(generator=gen, dtype=dtype, device=device)
    lo, hi = traffic["x0_range"]
    x0 = torch.rand((batch, plant["n"]), **kw) * (hi - lo) + lo
    s = traffic["param_scale"]

    def perturb(theta: Dict[str, float]) -> Dict[str, Tensor]:
        return {k: v * (1.0 + (torch.rand((batch,), **kw) * (2 * s) - s))
                for k, v in theta.items()}

    return x0, perturb(plant["theta0"]), perturb(plant["theta1"])
