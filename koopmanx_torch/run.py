"""RunConfig -> pipeline -> closed-loop results (counterpart of
``koopmanx/run.py``: ``build_dictionary`` :54-117 (mlp), ``_mpc_params``
:132-203, ``engine_config`` :206-251, ``_ref_fn`` :254-270 (constant) and
``build_pipeline`` :282-412).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import Tensor

from . import configs as C
from .device import DeviceLike, resolve_device, torch_dtype
from .edmd.batch import edmd_fit
from .edmd.rls import sqrt_rls_init
from .engine import ref as refgen
from .engine.core import check_supported
from .engine.loop import EngineConfig, MPCParams, make_closed_loop, run_batch
from .lifts.base import Dictionary, fit_normalizer, normalized
from .lifts.mlp import encoder_dictionary, mlp_init
from .systems.data import Snapshots, collect
from .systems.library import get_system
from .types import LinearModel


class Pipeline(NamedTuple):
    config: C.RunConfig
    dictionary: Dictionary
    data: Optional[Snapshots]
    model0: LinearModel
    rls0: Any
    engine_cfg: EngineConfig
    params: MPCParams
    closed_loop: Any  # callable, see engine.loop.make_closed_loop
    x_init: Tensor
    device: torch.device


def build_dictionary(cfg: C.RunConfig, data: Snapshots,
                     gen: torch.Generator) -> Dictionary:
    """The MLP lift: random He init from ``gen``, optionally normalized on
    the training states."""
    lc = cfg.lift
    system = get_system(cfg.system)
    dtype = torch_dtype(cfg.dtype)
    if lc.kind != "mlp":
        raise NotImplementedError(
            f"lift kind {lc.kind!r} is not ported yet (ROADMAP queue A, "
            "items 10-11)"
        )
    if lc.weights_path is not None:
        raise NotImplementedError(
            "loading encoder weights is not ported yet (ROADMAP queue A, "
            "L2: a port-own copy of lifts/io.py's .mat loader); set "
            "lift.weights_path=None for a random-init lift"
        )
    if lc.state_augmented or lc.zero_offset:
        raise NotImplementedError(
            "state-augmented / zero-offset lifts are not ported yet "
            "(ROADMAP queue A, L2)"
        )
    sizes = (system.n,) + (lc.hidden,) * 3 + (lc.nlift,)
    d = encoder_dictionary(mlp_init(gen, sizes, dtype=dtype), n=system.n)
    if lc.normalize:
        with torch.no_grad():
            mu, sc = fit_normalizer(d, data.x.to(dtype))
        d = normalized(d, mu, sc)
    return d


def _reference_state(cfg: C.RunConfig, n: int, dtype, device=None) -> Tensor:
    """The constant state-space reference: ``reference_state``, or
    ``reference_value`` on the first channel."""
    if cfg.reference_state is not None:
        return torch.tensor(cfg.reference_state, dtype=dtype, device=device)
    r = torch.zeros((n,), dtype=dtype, device=device)
    r[0] = cfg.reference_value
    return r


def mpc_params(cfg: C.RunConfig, system, device=None) -> MPCParams:
    """Output weight on the tracked outputs (both states for Duffing, or
    one channel with ``cy_index``), input weight and box."""
    mc = cfg.mpc
    kw = dict(dtype=torch_dtype(cfg.dtype), device=device)
    if mc.cy_index is not None:
        py = 1
        cy = torch.zeros((1, system.n), **kw)
        cy[0, mc.cy_index] = 1.0
    else:
        py, cy = system.n, None
    return MPCParams(
        q_block=mc.q_weight * torch.eye(py, **kw),
        r_block=mc.r_weight * torch.eye(system.m, **kw),
        u_min=torch.full((system.m,), mc.u_min, **kw),
        u_max=torch.full((system.m,), mc.u_max, **kw),
        cy=cy,
        ref_state=_reference_state(cfg, system.n, kw["dtype"], device),
    )


def engine_config(cfg: C.RunConfig) -> EngineConfig:
    """Translate a RunConfig into the static EngineConfig."""
    uc, mc = cfg.update, cfg.mpc
    if mc.state_bounds is not None or uc.warm_start_from_batch:
        raise NotImplementedError(
            "state_bounds / warm_start_from_batch are not ported yet "
            "(ROADMAP queue A, item 12 and L4)"
        )
    ecfg = EngineConfig(
        controller=mc.controller,
        horizon=mc.horizon,
        steps=cfg.steps,
        h=cfg.data.h,
        integrator=cfg.integrator,
        delta_u=mc.delta_u,
        track_lifted=mc.track_lifted,
        update=uc.mode,
        c_pairing=uc.c_pairing,
        rls_lambda=uc.forgetting,
        rls_ridge=uc.ridge,
        reset_mult=uc.reset_mult,
        reset_factor=uc.reset_factor,
        dither=uc.dither,
        switch_step=cfg.switch_step,
        markov=mc.markov,
        qp_iters=mc.qp_iters,
        qp_rho=mc.qp_rho,
        qp_kkt_block=mc.qp_kkt_block,
        qp_kkt_lowrank=mc.qp_kkt_lowrank,
        qp_kkt_bf16=mc.qp_kkt_bf16,
        qp_kkt_refine=mc.qp_kkt_refine,
        qp_backend=mc.qp_backend,
        terminal_synthesis=mc.terminal_synthesis,
    )
    check_supported(ecfg)
    return ecfg


def ref_fn_for(cfg: C.RunConfig, py: int, device=None):
    """The constant reference on the first ``py`` state channels."""
    if cfg.reference != "constant":
        raise NotImplementedError(
            f"reference {cfg.reference!r} is not ported yet (ROADMAP queue "
            "A, item 13)"
        )
    n = get_system(cfg.system).n
    dtype = torch_dtype(cfg.dtype)
    r_state = _reference_state(cfg, n, dtype)
    value = torch.zeros((py,), dtype=dtype)
    k = min(py, n)
    value[:k] = r_state[:k]
    return refgen.constant(value, cfg.mpc.horizon, py, dtype, device)


def build_pipeline(cfg: C.RunConfig, x_init=None,
                   device: DeviceLike = None) -> Pipeline:
    """Build the full pipeline for a run config on ``device`` (None means
    CUDA, which must be present).

    The one-time SETUP (data collection, lift init and normalizer, the
    pinv EDMD fit, the estimator init) runs on the CPU, and its results
    then move to the run's device. This mirrors the JAX package's stated
    correctness requirement (``koopmanx/run.py:282-325``): the batch fit's
    pseudo-inverse of ill-conditioned lifted Grams is reproduced reliably
    by host LAPACK in the run's dtype, as the reference does in NumPy; it
    is not a fallback.
    """
    dev = resolve_device(device)
    system = get_system(cfg.system)
    dtype = torch_dtype(cfg.dtype)
    engine_cfg = engine_config(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    data = collect(
        system, gen,
        n_step=cfg.data.n_step,
        n_traj=cfg.data.n_traj,
        h=cfg.data.h,
        u_range=cfg.data.u_range,
        x0_range=cfg.data.x0_range,
        integrator=cfg.integrator,
        clamp_x0=cfg.data.clamp_x0,
        dtype=dtype,
    )
    dictionary = build_dictionary(cfg, data, gen)
    with torch.no_grad():
        model0 = edmd_fit(dictionary, data)
    uc = cfg.update
    rls0 = sqrt_rls_init(dictionary.nlift, system.m, system.n, uc.c_ab,
                         uc.c_c, dtype)
    if x_init is None:
        x_init = cfg.x0 if cfg.x0 is not None else (-2.0,) * system.n
    x_init = torch.as_tensor(x_init, dtype=dtype)

    to = lambda tree: type(tree)(*(t.to(dev) for t in tree))
    dictionary = dictionary.to(dev)
    params = mpc_params(cfg, system, dev)
    return Pipeline(
        config=cfg,
        dictionary=dictionary,
        data=to(data),
        model0=to(model0),
        rls0=to(rls0),
        engine_cfg=engine_cfg,
        params=params,
        closed_loop=make_closed_loop(
            system, dictionary, engine_cfg,
            ref_fn_for(cfg, params.q_block.shape[0], dev),
        ),
        x_init=x_init.to(dev),
        device=dev,
    )


def replicate(tree, batch: int):
    """Broadcast every tensor leaf of a NamedTuple to a leading scenario
    axis (a view; the engine never writes into its inputs)."""
    return type(tree)(*(
        None if t is None else t.expand((batch,) + t.shape) for t in tree
    ))


def run_scenarios(pipe: Pipeline, batch):
    """Run a ScenarioBatch; returns (final LoopCarry, StepLog (B, T, ...))."""
    b = batch.x0.shape[0]
    return run_batch(
        pipe.closed_loop,
        replicate(pipe.params, b),
        batch.x0,
        replicate(pipe.model0, b),
        replicate(pipe.rls0, b),
        batch.theta0,
        batch.theta1,
    )
