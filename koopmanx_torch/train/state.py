"""A KMAE training state as plain numpy arrays: the JAX package's
``KMAEState`` leaf for leaf, the schema of both packages' checkpoints.

The arrays are the dict ``{"encoder": [(W, b), ...], "decoder": [...],
"count": int, "mu": {"encoder": [...], "decoder": [...]}, "nu": {...},
"a_prev": (nlift, nlift), "b_prev": (nlift, m)}``: the parameters,
optax Adam's ``ScaleByAdamState`` and the carried model.
:func:`kmae_leaves` flattens it in ``jax.tree_util.tree_flatten`` order.

Only an Adam optimizer's state has that form (torch's ``Adam`` or
``AdamW`` without ``amsgrad``: ``step``, ``exp_avg`` and ``exp_avg_sq``
are optax's ``count``, ``mu`` and ``nu``), so only such a state converts.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..lifts.mlp import MLP
from ..tree import host_numpy
from .kmae import KMAEConfig, KMAEParams, KMAEState, adam

_MLPS = ("encoder", "decoder")


def _flat(tree: Dict[str, Any]) -> list:
    """W1, b1, ... of the encoder, then of the decoder."""
    return [x for key in _MLPS for pair in tree[key] for x in pair]


def _pairs(flat: Sequence, sizes: Sequence[int]) -> Dict[str, list]:
    """The inverse of :func:`_flat` for MLPs of ``sizes`` layers."""
    out, i = {}, 0
    for key, layers in zip(_MLPS, sizes):
        out[key] = [(flat[i + 2 * k], flat[i + 2 * k + 1])
                    for k in range(layers)]
        i += 2 * layers
    return out


def check_adam(opt: torch.optim.Optimizer) -> None:
    """Raise unless ``opt``'s state is optax Adam's ``ScaleByAdamState``."""
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)) or any(
            g.get("amsgrad", False) for g in opt.param_groups):
        raise ValueError(
            f"only an Adam or AdamW optimizer without amsgrad converts to "
            f"the JAX package's ScaleByAdamState, not {type(opt).__name__}")


def kmae_leaves(arrays: Dict[str, Any]) -> List[np.ndarray]:
    """A KMAE state's arrays in ``jax.tree_util.tree_flatten`` order of a
    JAX ``KMAEState``: the parameters, Adam's ``count`` (int32), ``mu``
    and ``nu`` (each in the parameters' order; optax's ``EmptyState`` of
    the learning-rate scale has no leaf), then ``a_prev`` and ``b_prev``."""
    return [*_flat(arrays), np.asarray(arrays["count"], dtype=np.int32),
            *_flat(arrays["mu"]), *_flat(arrays["nu"]), arrays["a_prev"],
            arrays["b_prev"]]


def kmae_arrays_from_leaves(leaves: Sequence[np.ndarray],
                            sizes: Sequence[int]) -> Dict[str, Any]:
    """The inverse of :func:`kmae_leaves`, for an encoder and a decoder of
    ``sizes`` = (encoder layers, decoder layers)."""
    p = 2 * sum(sizes)
    if len(leaves) != 3 * p + 3:
        raise ValueError(f"{len(leaves)} leaves do not make a KMAE state "
                         f"of {sizes} layers ({3 * p + 3} expected)")
    return {**_pairs(leaves[:p], sizes), "count": int(leaves[p]),
            "mu": _pairs(leaves[p + 1:2 * p + 1], sizes),
            "nu": _pairs(leaves[2 * p + 1:3 * p + 1], sizes),
            "a_prev": leaves[3 * p + 1], "b_prev": leaves[3 * p + 2]}


def kmae_state_to_numpy(state: KMAEState) -> Dict[str, Any]:
    """A KMAE state's arrays from its modules, its Adam optimizer's
    ``step``, ``exp_avg`` and ``exp_avg_sq`` (zeros and count 0 before its
    first step) and the carried model."""
    check_adam(state.opt_state)
    copy = lambda t: np.array(host_numpy(t))  # not a view of a CPU tensor
    leaves = state.params.leaves()
    mu, nu, counts = [], [], set()
    for p in leaves:
        st = state.opt_state.state.get(p, {})
        zero = torch.zeros_like(p)
        counts.add(int(st["step"]) if st else 0)
        mu.append(copy(st["exp_avg"] if st else zero))
        nu.append(copy(st["exp_avg_sq"] if st else zero))
    if len(counts) != 1:
        raise ValueError(f"the parameters have different Adam steps {counts}")
    sizes = [len(mlp.layers) for mlp in state.params]
    return {**_pairs([copy(p) for p in leaves], sizes),
            "count": counts.pop(), "mu": _pairs(mu, sizes),
            "nu": _pairs(nu, sizes), "a_prev": copy(state.a_prev),
            "b_prev": copy(state.b_prev)}


def load_kmae_numpy(state: KMAEState, arrays: Dict[str, Any]) -> KMAEState:
    """``arrays`` loaded into ``state`` in place (its parameters, and its
    Adam optimizer's moments with ``step`` = ``count``, which sets the
    bias corrections), in the state's dtype and on its device; returns
    the state with the carried model replaced."""
    check_adam(state.opt_state)
    leaves = state.params.leaves()
    like = lambda a, ref: torch.tensor(np.array(a), dtype=ref.dtype,
                                       device=ref.device)
    step = torch.tensor(float(arrays["count"]))
    with torch.no_grad():
        for p, v, m, s in zip(leaves, _flat(arrays), _flat(arrays["mu"]),
                              _flat(arrays["nu"])):
            p.copy_(like(v, p))
            state.opt_state.state[p] = {"step": step.clone(),
                                        "exp_avg": like(m, p),
                                        "exp_avg_sq": like(s, p)}
    return state._replace(a_prev=like(arrays["a_prev"], state.a_prev),
                          b_prev=like(arrays["b_prev"], state.b_prev))


def kmae_state_from_numpy(arrays: Dict[str, Any], device: DeviceLike = None,
                          dtype: torch.dtype = torch.float32) -> KMAEState:
    """A port ``KMAEState`` from a JAX one's arrays: the modules, the
    default Adam (``KMAEConfig().lr``) carrying the moments and the step
    count, and the carried model. For another Adam, load the arrays into
    a state from ``init_state(..., optimizer=...)`` with
    :func:`load_kmae_numpy`."""
    dev = resolve_device(device)
    mlp = lambda pairs: MLP.from_params([
        (torch.tensor(np.array(w), dtype=dtype),
         torch.tensor(np.array(b), dtype=dtype)) for w, b in pairs]).to(dev)
    params = KMAEParams(*(mlp(arrays[key]) for key in _MLPS))
    t = lambda a: torch.tensor(np.array(a), dtype=dtype, device=dev)
    state = KMAEState(params=params,
                      opt_state=adam(KMAEConfig())(params.leaves()),
                      a_prev=t(arrays["a_prev"]), b_prev=t(arrays["b_prev"]))
    return load_kmae_numpy(state, arrays)
