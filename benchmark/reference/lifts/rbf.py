"""Thin-plate RBFs with a small offset, d^2 log(d + 1e-4) for d the
distance to each center (``duffing_RBF.py:20-23``), against the centers the
configuration pins in a ``.mat`` file (``lift.rbf_centers``, key
``centers``), held as the configuration's dtype holds them. The squared
distance is |x|^2 + |c|^2 - 2 x c', its cross term through the
reference's product, so that the control's TF32 rounds it as a lift built
on a matrix product would; floored at 0."""
import os

import numpy as np
import scipy.io
import torch


def dictionary(lift, root, store, kw):
    if lift["rbf_type"] != "thinplate_eps":
        raise NotImplementedError(f"RBF type {lift['rbf_type']!r}")
    data = scipy.io.loadmat(os.path.join(root, lift["rbf_centers"]))
    centers = torch.tensor(np.asarray(data["centers"], np.float64))
    centers = centers.to(store).to(**kw)
    c2 = (centers * centers).sum(-1)

    def g(mm, x):
        r2 = (x * x).sum(-1, keepdim=True) + c2 - 2.0 * mm(x, centers.T)
        r2 = torch.clamp(r2, min=0.0)
        return r2 * torch.log(torch.sqrt(r2) + 1e-4)

    return g
