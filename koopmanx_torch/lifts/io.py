"""Weight interchange: the ``.mat`` MLP importer and exporter (a port-own
copy of ``koopmanx/lifts/io.py:23-50``).

The schema is ``W1..Wk`` with shape (out, in) and ``b1..bk`` with shape
(1, out), as the reference's exports and the in-repo ``artifacts/*.mat``
hold them. The torch-pickle importer of the JAX package is not ported: it
reads only the reference's own checkpoints.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor


def load_mat_mlp(path: str, dtype: torch.dtype = torch.float32
                 ) -> List[Tuple[Tensor, Tensor]]:
    """Load ``W1..Wk / b1..bk`` MLP weights from a ``.mat`` file as
    ``[(W (out, in), b (out,)), ...]`` on the CPU, read through float64."""
    import scipy.io as sio

    data = sio.loadmat(path)
    params = []
    i = 1
    while f"W{i}" in data:
        w = np.asarray(data[f"W{i}"], dtype=np.float64)
        b = np.asarray(data[f"b{i}"], dtype=np.float64).reshape(-1)
        params.append((torch.tensor(w, dtype=dtype),
                       torch.tensor(b, dtype=dtype)))
        i += 1
    if not params:
        raise ValueError(f"no W1..Wk keys found in {path}")
    return params


def save_mat_mlp(path: str, params: Sequence[Tuple[Tensor, Tensor]]) -> None:
    """Write ``[(W (out, in), b (out,)), ...]`` in the same schema: ``W{i}``
    (out, in) and ``b{i}`` (1, out), in the tensors' own dtype."""
    import scipy.io as sio

    out = {}
    for i, (w, b) in enumerate(params, start=1):
        out[f"W{i}"] = w.detach().cpu().numpy()
        out[f"b{i}"] = b.detach().cpu().numpy().reshape(1, -1)
    sio.savemat(path, out)
