"""KMAE training loop, checkpoints and the weight export (counterpart of
``koopmanx/train/trainer.py``).

The reference's loop (DeepLearning_KoopmanControl_Approach3.py:462-563):
epochs of minibatches, each refitting (A, B) by EDMD over the whole
snapshot set and backpropagating the blended multi-step loss over a
minibatch of windows; past epoch 5 only the reconstruction term; the
encoder and decoder exported in the reference's ``.mat`` schema
(:565-566).

Checkpoints are the JAX package's ``.npz``, leaf for leaf: ``step``,
``n_leaves`` and ``leaf_i`` in ``jax.tree_util.tree_flatten`` order of a
JAX ``KMAEState`` (``train/state.py::kmae_leaves``), so that a run checkpointed by
either package resumes in the other.
"""
from __future__ import annotations

import copy
import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..lifts.io import save_mat_mlp
from ..systems.data import Snapshots
from .kmae import (
    KMAEConfig,
    KMAEState,
    OptimizerFactory,
    init_state,
    kmae_loss,
    make_train_step,
    make_windows,
)
from .state import (
    check_adam,
    kmae_arrays_from_leaves,
    kmae_leaves,
    kmae_state_to_numpy,
    load_kmae_numpy,
)


def save_checkpoint(path: str, state: KMAEState, step: int) -> None:
    leaves = kmae_leaves(kmae_state_to_numpy(state))
    np.savez(path, step=step, n_leaves=len(leaves),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})


def load_checkpoint(path: str, template: KMAEState) -> Tuple[KMAEState, int]:
    """The checkpoint's state loaded into ``template`` (its modules and
    optimizer, in place; the template's structure reads the leaves), and
    its step."""
    data = np.load(path)
    leaves = [data[f"leaf_{i}"] for i in range(int(data["n_leaves"]))]
    arrays = kmae_arrays_from_leaves(
        leaves, [len(mlp.layers) for mlp in template.params])
    return load_kmae_numpy(template, arrays), int(data["step"])


def fit(
    data: Snapshots,
    n_step: int,
    cfg: KMAEConfig = KMAEConfig(),
    nlift: int = 8,
    hidden: int = 100,
    seed: int = 0,
    batch_windows: int = 256,
    dtype: torch.dtype = torch.float32,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 5,
    resume: bool = False,
    log_every: int = 1,
    verbose: bool = True,
    optimizer: Optional[OptimizerFactory] = None,
    eval_callback: Optional[Callable[[KMAEState, int], float]] = None,
    eval_every: int = 5,
    device: DeviceLike = None,
):
    """Train the encoder and decoder on trajectory-major snapshots, on
    ``device`` (the card unless the caller asks for the CPU). Returns
    ``(state, history)``, history a list of per-epoch dicts.

    The initial state and each epoch's shuffle are drawn from one
    ``torch.Generator`` seeded with ``seed``, in that order (a resumed
    run's shuffles start anew, as in the JAX package). ``optimizer`` is a
    factory ``params -> torch.optim.Optimizer``; the default is the
    reference's constant-lr Adam (DeepLearning...py:58).

    ``eval_callback(state, epoch) -> score`` runs every ``eval_every``
    epochs and after the last; the state of the lowest score is the one
    returned and, with ``checkpoint_path``, the one checkpointed. The
    scores land in history as ``val_score``. The epoch's ``loss`` is the
    mean of its steps' losses, read from the device once an epoch.

    Checkpoints hold optax Adam's state, so with ``checkpoint_path`` the
    optimizer must be an Adam or AdamW without amsgrad (ValueError
    before the first step otherwise); the best-state selection takes any
    optimizer.
    """
    dev = resolve_device(device)
    n = data.x.shape[-1]
    gen = torch.Generator().manual_seed(seed)
    state = init_state(gen, cfg, n=n, nlift=nlift, hidden=hidden,
                       dtype=dtype, optimizer=optimizer, device=dev)
    start_epoch = 0
    if checkpoint_path:
        check_adam(state.opt_state)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, start_epoch = load_checkpoint(checkpoint_path, state)

    x_snap, y_snap, u_snap = (t.to(dev, dtype) for t in data)
    x_win, u_win = make_windows(x_snap, y_snap, u_snap, n_step,
                                cfg.pred_horizon)
    n_win = x_win.shape[0]
    train_step, _ = make_train_step(cfg, optimizer)
    steps_per_epoch = max(1, n_win // batch_windows)
    history = []
    best, best_score = None, math.inf

    for epoch in range(start_epoch, cfg.epochs):
        rec_only = (cfg.rec_only_after_epoch is not None
                    and epoch > cfg.rec_only_after_epoch)
        perm = torch.randperm(n_win, generator=gen).to(dev)
        losses = []
        for b in range(steps_per_epoch):
            idx = perm[b * batch_windows:(b + 1) * batch_windows]
            state, loss, aux = train_step(state, x_snap, y_snap, u_snap,
                                          x_win[idx], u_win[idx], rec_only)
            losses.append(loss)
        rec = {
            "epoch": epoch,
            "loss": float(torch.stack(losses).double().mean()),
            "l_rec": float(aux["l_rec"]),
            "l_lin": float(aux["l_lin"]),
            "l_pred": float(aux["l_pred"]),
            "rec_only": rec_only,
        }
        if verbose and epoch % log_every == 0:
            print(f"epoch {epoch}: loss={rec['loss']:.4f} "
                  f"(rec {rec['l_rec']:.4f} lin {rec['l_lin']:.4f} "
                  f"pred {rec['l_pred']:.4f})"
                  f"{' [rec-only]' if rec_only else ''}")
        if eval_callback is not None and (
                (epoch + 1) % eval_every == 0 or epoch == cfg.epochs - 1):
            score = float(eval_callback(state, epoch))
            rec["val_score"] = score
            if score < best_score:
                best_score, best = score, _snapshot(state)
                rec["val_best"] = True
            if verbose:
                print(f"  [val] epoch {epoch}: score={score:.5g} "
                      f"(best {best_score:.5g})")
        history.append(rec)
        if checkpoint_path and (epoch + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, state, epoch + 1)
    if best is not None:
        # what is returned (and exported) is what the checkpoint holds
        state = _restore(state, best)
    if checkpoint_path:
        save_checkpoint(checkpoint_path, state, cfg.epochs)
    return state, history


def _snapshot(state: KMAEState):
    """A copy of ``state`` that later steps do not change, for any
    optimizer."""
    return ([copy.deepcopy(mlp.state_dict()) for mlp in state.params],
            copy.deepcopy(state.opt_state.state_dict()),
            state.a_prev.clone(), state.b_prev.clone())


def _restore(state: KMAEState, snap) -> KMAEState:
    """``state`` set back to :func:`_snapshot`'s copy, in place."""
    modules, opt, a_prev, b_prev = snap
    for mlp, sd in zip(state.params, modules):
        mlp.load_state_dict(sd)
    state.opt_state.load_state_dict(opt)
    return state._replace(a_prev=a_prev, b_prev=b_prev)


def export_weights(state: KMAEState, path_prefix: str) -> None:
    """The encoder and decoder in the reference's ``.mat`` schema
    (duffing.py:61-64: W (out, in), b (1, out)):
    ``<prefix>_encoder.mat`` and ``<prefix>_decoder.mat``."""
    save_mat_mlp(path_prefix + "_encoder.mat", state.params.encoder.params())
    save_mat_mlp(path_prefix + "_decoder.mat", state.params.decoder.params())


def evaluate(state: KMAEState, data: Snapshots, n_step: int,
             cfg: KMAEConfig = KMAEConfig(),
             dtype: torch.dtype = torch.float32) -> dict:
    """The loss and its parts on fresh data, no backward pass (the
    reference's inference-side report, duffing.py:179-235), on the
    state's device."""
    dev = state.a_prev.device
    x, y, u = (t.to(dev, dtype) for t in data)
    x_win, u_win = make_windows(x, y, u, n_step, cfg.pred_horizon)
    with torch.no_grad():
        loss, aux = kmae_loss(state.params, state.a_prev, state.b_prev, x, y,
                              u, x_win, u_win, cfg)
    return {"loss": float(loss), "l_rec": float(aux["l_rec"]),
            "l_lin": float(aux["l_lin"]), "l_pred": float(aux["l_pred"])}
