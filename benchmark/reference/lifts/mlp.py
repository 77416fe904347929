"""The encoder's ReLU MLP, its layers W1, b1, ..., Wk, bk read from the
configuration's ``.mat`` file and held as the configuration's dtype
holds them."""
import os

import numpy as np
import scipy.io
import torch


def dictionary(lift, root, store, kw):
    data = scipy.io.loadmat(os.path.join(root, lift["weights_path"]))
    layers, i = [], 1
    while f"W{i}" in data:
        w = torch.tensor(np.asarray(data[f"W{i}"], np.float64))
        b = torch.tensor(np.asarray(data[f"b{i}"], np.float64)).reshape(-1)
        layers.append((w.to(store).to(**kw), b.to(store).to(**kw)))
        i += 1
    if not layers:
        raise ValueError(f"no W1..Wk in {lift['weights_path']}")

    def g(mm, h):
        for i, (w, b) in enumerate(layers):
            h = mm(h, w.transpose(-1, -2)) + b
            if i < len(layers) - 1:
                h = torch.relu(h)
        return h

    return g
