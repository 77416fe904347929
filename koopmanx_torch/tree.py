"""Maps over the trees the engine carries: NamedTuples and tuples whose
leaves are tensors, with ``None`` and ``()`` standing for absent parts
(the refit lane's carried statistics, the certificate without synthesis).
The port's counterpart of the ``jax.tree_util`` calls the JAX package
makes on the same trees: ``None`` and ``()`` hold no leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        children = [tree_map(fn, *parts) for parts in zip(tree, *rest)]
        return (type(tree)(*children) if hasattr(tree, "_fields")
                else tuple(children))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, depth first, in field order."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    return [tree]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with ``leaves`` in place of its own."""
    if len(leaves) != len(tree_leaves(template)):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(tree_leaves(template))}")
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf's host copy as numpy; bfloat16, which numpy lacks, widens to
    float32, which holds it exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
