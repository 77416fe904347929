"""The serving API (counterpart of ``koopmanx/engine/controller.py``): a
stateful ``step(x) -> u`` controller for plants the caller owns.

The fused loop (:mod:`koopmanx_torch.engine.loop`) steps its own plant;
in deployment the plant is outside and its measurements arrive one call
at a time. :class:`BatchedController` serves a fleet of plants in one
call, every tensor with the plant axis first; :class:`Controller` is a
fleet of one taking and returning unbatched vectors::

    ctrl = Controller.from_pipeline(pipe)
    u = ctrl.step(x_measured)   # apply u to the plant, measure x again

The per-step bodies are the loop's own (:func:`make_control_solver`,
:func:`make_estimator_update`, :func:`change_reset`), run in the same
order, so a controller driven by the loop's plant reproduces the loop.
The loop absorbs ``(z_k, u_k, z_{k+1})`` inside step k; here the pair
arrives at call k+1 as ``(z_prev, u_prev, z)`` and the estimator is given
its origin step k-1; on a plant's first call there is no pair and its
model and estimator are held.

Each plant has its own episode clock (JAX ``vmap``-ed the step index per
plant): after a masked :meth:`BatchedController.reset` the plants reset
restart at 0 and the others keep counting. The clocks live on the host;
while they agree the engine gets one int, as in the loop, and otherwise
a (B,) tensor of per-plant steps. Every ``step`` runs under
``torch.inference_mode()``. Under ``qp_kkt_refine`` the state carries
each plant's KKT inverse, which a reset returns to its seed, so a reset
plant re-anchors exactly on its own clock's step 0.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor

from ..device import DeviceLike, resolve_device
from ..lifts.base import Dictionary
from ..tree import tree_map
from ..types import LinearModel
from .core import (
    EngineConfig,
    MPCParams,
    _select,
    change_reset,
    dual_dim,
    initial_cert,
    initial_kkt_inv,
    make_control_solver,
    make_estimator_update,
)
from .loop import _matvec
from .ref import RefFn, Step


class ControllerState(NamedTuple):
    """What a controller carries between calls, per plant (leading axis
    B); a tree the caller may checkpoint (``eval.persist.save_pytree``)."""

    model: LinearModel
    rls: Any  # the estimator state of ``cfg.update``
    u_prev: Tensor  # (B, m) last applied input (the du accumulator)
    warm_x: Tensor  # (B, N*m) QP primal warm start
    warm_y: Any  # (B, dual_dim) under qp_warm_start='full', else ()
    z_prev: Tensor  # (B, nlift) lift of the previous measurement
    x_prev: Tensor  # (B, n) previous measurement (c_pairing='same')
    have_prev: Tensor  # (B,) bool: a (z_prev, u_prev, z) pair exists
    res_ema: Tensor  # (B,) change-detection residual average
    cert: Any  # the last certificate (P, K, gamma) that passed, or ()
    kkt_inv: Any = ()  # (B, N*m, N*m) the carried KKT inverse, or ()


def make_step_fn(dictionary: Dictionary, cfg: EngineConfig, ref_fn: RefFn,
                 m: int):
    """``step_fn(params, state, x, step) -> (state', u)`` for a fleet:
    ``x`` (B, n), ``step`` an int or (B,) per-plant steps."""
    solve = make_control_solver(cfg, ref_fn, m, dictionary)
    estimate = make_estimator_update(dictionary, cfg)

    def step_fn(params: MPCParams, state: ControllerState, x: Tensor,
                step: Step):
        z = dictionary(x)
        model, rls, res_ema = state.model, state.rls, state.res_ema
        if cfg.update != "off":
            c_target = x if cfg.c_pairing == "next" else state.x_prev
            rls_new, model_new = estimate(rls, model, state.z_prev,
                                          state.u_prev, z, c_target, step - 1)
            residual = torch.linalg.vector_norm(
                z - (_matvec(model.A, state.z_prev)
                     + _matvec(model.B, state.u_prev)), dim=-1)
            rls_new, res_ema_new = change_reset(cfg, rls_new, res_ema,
                                                residual)
            use = state.have_prev  # hold everything without a pair
            rls = _select(use, rls_new, rls)
            model = _select(use, model_new, model)
            res_ema = torch.where(use, res_ema_new, res_ema)
        dec = solve(params, model, z, state.u_prev, state.warm_x,
                    state.warm_y, step, state.cert, x, state.kkt_inv)
        new_state = ControllerState(
            model=model,
            rls=rls,
            u_prev=dec.u_applied,
            warm_x=dec.warm_x,
            warm_y=dec.sol.y if cfg.qp_warm_start == "full" else state.warm_y,
            z_prev=z,
            x_prev=x,
            have_prev=torch.ones_like(state.have_prev),
            res_ema=res_ema,
            cert=dec.cert,
            kkt_inv=dec.kkt_inv,
        )
        return new_state, dec.u_applied

    return step_fn


def initial_state(dictionary: Dictionary, cfg: EngineConfig,
                  params: MPCParams, model0: LinearModel, rls0, batch: int,
                  n: Optional[int] = None) -> ControllerState:
    """A fresh fleet state, as ``closed_loop``'s initial carry: every
    argument with the plant axis first."""
    m = params.r_block.shape[-1]
    n = model0.C.shape[-2] if n is None else n
    dtype, dev = params.q_block.dtype, params.q_block.device
    zeros = lambda *shape: torch.zeros((batch,) + shape, dtype=dtype,
                                       device=dev)
    return ControllerState(
        model=model0,
        rls=rls0,
        u_prev=zeros(m),
        warm_x=zeros(cfg.horizon * m),
        warm_y=(zeros(dual_dim(cfg, params, m))
                if cfg.qp_warm_start == "full" else ()),
        z_prev=zeros(dictionary.nlift),
        x_prev=zeros(n),
        have_prev=torch.zeros((batch,), dtype=torch.bool, device=dev),
        res_ema=zeros(),
        cert=initial_cert(cfg, params, dictionary.nlift, m, batch, dtype,
                          dev),
        kkt_inv=initial_kkt_inv(cfg, m, batch, dtype, dev),
    )


def _replicate(tree, batch: int):
    return tree_map(lambda t: t.expand((batch,) + t.shape), tree)


def _ref_fn_of(pipe):
    from ..run import ref_fn_for

    return ref_fn_for(pipe.config, pipe.params.q_block.shape[-1], pipe.device,
                      pipe.dictionary)


class BatchedController:
    """Many plants, one call: ``step(X) -> U`` over the leading plant axis.

    ``batch_params`` / ``batch_model``: ``params`` / ``model0`` and
    ``rls0`` carry the plant axis (per-plant weights; per-plant starting
    models and estimators); otherwise they are shared by every plant.
    ``device`` None means CUDA, which must be present; the inputs move
    there, and ``ref_fn`` must give its windows there."""

    def __init__(self, dictionary: Dictionary, cfg: EngineConfig,
                 params: MPCParams, ref_fn: RefFn, model0: LinearModel, rls0,
                 batch: int, batch_params: bool = False,
                 batch_model: bool = False, n: Optional[int] = None,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        to = lambda tree: tree_map(lambda t: t.to(dev), tree)
        params, model0, rls0 = to(params), to(model0), to(rls0)
        dictionary = dictionary.to(dev)
        if not batch_params:
            params = _replicate(params, batch)
        if not batch_model:
            model0, rls0 = _replicate(model0, batch), _replicate(rls0, batch)
        self.cfg = cfg
        self.params = params
        self.device = dev
        self.dtype = params.q_block.dtype
        self._step = make_step_fn(dictionary, cfg, ref_fn,
                                  params.r_block.shape[-1])
        self._init = initial_state(dictionary, cfg, params, model0, rls0,
                                   batch, n)
        self.state = self._init
        self._k = np.zeros((batch,), np.int64)  # the episode clocks

    @classmethod
    def from_pipeline(cls, pipe, batch: int) -> "BatchedController":
        """``batch`` plants sharing the pipeline's weights, starting model
        and estimator, on its device."""
        return cls(pipe.dictionary, pipe.engine_cfg, pipe.params,
                   _ref_fn_of(pipe), pipe.model0, pipe.rls0, batch=batch,
                   device=pipe.device)

    @property
    def clocks(self) -> np.ndarray:
        """Each plant's episode clock: the step its next call solves."""
        return self._k.copy()

    def step(self, x_batch) -> Tensor:
        """One control step of every plant from its measurement (B, n),
        cast to the controller's dtype and device; returns the inputs to
        apply (B, m)."""
        x = torch.as_tensor(x_batch, dtype=self.dtype, device=self.device)
        k = self._k
        step = int(k[0]) if (k == k[0]).all() else torch.from_numpy(k)
        with torch.inference_mode():
            self.state, u = self._step(self.params, self.state, x, step)
        self._k = k + 1  # a new array: the step tensor above keeps its own
        return u

    def reset(self, full: bool = False, mask=None) -> None:
        """A new episode for the whole fleet (``mask`` None) or for the
        plants where the (B,) bool ``mask`` is True. A reset plant clears
        its warm starts, previous input and measurement, pair flag and
        clock, and keeps what adaptation produced (the model, the
        estimator, the certificate, the residual average) unless ``full``,
        which restores the starting ones too. New tensors throughout: the
        starting state may share storage with the caller's inputs."""
        new = self._init if full else self._init._replace(
            model=self.state.model, rls=self.state.rls,
            cert=self.state.cert, res_ema=self.state.res_ema)
        if mask is None:
            self.state = new
            self._k = np.zeros_like(self._k)
            return
        pick = (mask.cpu() if isinstance(mask, Tensor) else
                torch.as_tensor(np.asarray(mask))).to(torch.bool)
        if tuple(pick.shape) != self._k.shape:
            raise ValueError(f"mask shape {tuple(pick.shape)} != fleet "
                             f"shape {self._k.shape}")
        self._k = np.where(pick.numpy(), 0, self._k)
        pick = pick.to(self.device)
        where = lambda a, b: torch.where(
            pick.reshape(pick.shape + (1,) * (a.dim() - 1)), a, b)
        with torch.inference_mode():
            self.state = tree_map(where, new, self.state)


class Controller(BatchedController):
    """One plant: ``step(x) -> u`` on unbatched vectors, a fleet of one
    (its state carries a plant axis of 1)."""

    def __init__(self, dictionary: Dictionary, cfg: EngineConfig,
                 params: MPCParams, ref_fn: RefFn, model0: LinearModel, rls0,
                 n: Optional[int] = None, device: DeviceLike = None):
        super().__init__(dictionary, cfg, params, ref_fn, model0, rls0,
                         batch=1, n=n, device=device)

    @classmethod
    def from_pipeline(cls, pipe) -> "Controller":
        return cls(pipe.dictionary, pipe.engine_cfg, pipe.params,
                   _ref_fn_of(pipe), pipe.model0, pipe.rls0,
                   device=pipe.device)

    def step(self, x) -> Tensor:
        """One control step from a measurement (n,); returns the input to
        apply (m,)."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        return super().step(x.unsqueeze(0))[0]

    def reset(self, full: bool = False) -> None:
        super().reset(full)
