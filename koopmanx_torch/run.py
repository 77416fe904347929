"""RunConfig -> pipeline -> closed-loop results (counterpart of
``koopmanx/run.py``: ``build_dictionary`` :54-117 (mlp, with the
``.mat`` or ``.pkl`` weights and their fallback; rbf with random or
k-means centers; random Fourier features; the identity, Hermite and
monomial lifts), ``_mpc_params`` :132-203 (lifted tracking included), ``engine_config`` :206-251, ``_ref_fn``
:254-280 and ``build_pipeline`` :282-412, with every estimator's initial
state: the windowed estimator's prefilled ring, compressed or not, and the
Woodbury lane's carried statistics; the storage method's training Grams; the
SM, Gram-carry and square-root RLS priors, or their warm starts from the
training Grams), ``run_single`` :415 (one scenario as a batch of one) and
``run_resumable`` :438-499 (the loop in checkpointed chunks);
``with_engine_config`` rebuilds a pipeline's loop on other engine fields.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, NamedTuple, Optional

import torch
from torch import Tensor

from . import configs as C
from .device import DeviceLike, resolve_device, torch_dtype
from .edmd.batch import edmd_fit, gram_stats
from .edmd.rls import (
    gram_rls_init,
    gram_rls_init_from_grams,
    rls_init,
    rls_init_from_grams,
    sqrt_rls_init,
    sqrt_rls_init_from_grams,
    storage_init,
)
from .edmd.windowed import window_init, window_prefill
from .engine import ref as refgen
from .engine.core import check_supported
from .engine.local_linear import make_local_linear_loop
from .engine.loop import EngineConfig, MPCParams, make_closed_loop, run_batch
from .lifts.base import (
    Dictionary,
    constant_augmented,
    fit_normalizer,
    identity_dictionary,
    normalized,
    state_augmented,
    zero_offset,
)
from .lifts.fourier import fourier_dictionary, rff_init
from .lifts.io import load_mat_mlp, load_torch_autoencoder
from .lifts.mlp import MLP, encoder_dictionary, mlp_init
from .lifts.poly import hermite_dictionary, monomial_dictionary
from .lifts.rbf import kmeans, rbf_dictionary
from .systems.data import Snapshots, collect, uniform
from .systems.library import get_system
from .tree import tree_map
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


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def resolve_weights_path(path: Optional[str], system: str) -> Optional[str]:
    """The ``.mat`` file an MLP lift loads: ``path`` (a relative one
    against the repo root) if it exists, else the in-repo artifact
    ``artifacts/<system>_kmae_encoder.mat`` if that exists, else None (a
    random-init lift), as ``koopmanx/run.py:65-75`` does."""
    if not path:
        return None
    full = os.path.join(REPO_ROOT, path)  # an absolute path stays itself
    if os.path.exists(full):
        return full
    alt = os.path.join(REPO_ROOT, "artifacts", f"{system}_kmae_encoder.mat")
    return alt if os.path.exists(alt) else None


def load_mlp_weights(path: str, dtype: torch.dtype):
    """An MLP lift's weights ``[(W (out, in), b (out,)), ...]`` from a
    ``.mat`` file or, for a ``.pkl``, the encoder of a torch checkpoint
    (``lifts.io.load_torch_autoencoder``); None for any other suffix,
    where the JAX package falls back to a random init
    (``koopmanx/run.py:76-82``)."""
    if path.endswith(".mat"):
        return load_mat_mlp(path, dtype)
    if path.endswith(".pkl"):
        return load_torch_autoencoder(path, dtype)[0]
    return None


def build_dictionary(cfg: C.RunConfig, data: Snapshots,
                     gen: torch.Generator) -> Dictionary:
    """The lift: an MLP (its ``.mat`` weights or a ``.pkl`` checkpoint's
    encoder, or a random He init from ``gen``), thinplate-family RBFs
    with k-means centers over the training states or centers
    ~ U[0, 1)^n, or random Fourier features whose bandwidth is in units
    of the training states' std (ddof 0, floored at 1e-3), all drawn
    from ``gen``; or psi(x) = x, the tensor-product
    Hermite lift of degree 4 (nlift 25) or the five monomials (the last
    two over 2-D states); then ``zero_offset``,
    ``state_augmented`` (the two together are [x; g(x) - g(0)]); then
    ``normalized`` on the training states."""
    lc = cfg.lift
    system = get_system(cfg.system)
    dtype = torch_dtype(cfg.dtype)
    if lc.kind == "identity":
        d = identity_dictionary(system.n)
    elif lc.kind == "mlp":
        path = resolve_weights_path(lc.weights_path, system.name)
        weights = None if path is None else load_mlp_weights(path, dtype)
        if weights is not None:
            d = encoder_dictionary(MLP.from_params(weights), n=system.n)
        else:
            sizes = (system.n,) + (lc.hidden,) * 3 + (lc.nlift,)
            d = encoder_dictionary(mlp_init(gen, sizes, dtype=dtype),
                                   n=system.n)
    elif lc.kind == "rbf":
        if lc.rbf_centers == "kmeans":
            centers, _ = kmeans(gen, data.x.to(dtype), lc.nlift)
        else:
            centers = uniform(gen, (lc.nlift, system.n), 0.0, 1.0, dtype)
        d = rbf_dictionary(centers, lc.rbf_type)
    elif lc.kind == "fourier":
        scale = torch.clamp(data.x.to(dtype).std(0, correction=0), min=1e-3)
        w, b = rff_init(gen, system.n, lc.nlift, bandwidth=lc.rff_bandwidth,
                        feature_scale=scale, dtype=dtype)
        d = fourier_dictionary(w, b)
    elif lc.kind == "hermite":
        d = hermite_dictionary()
    elif lc.kind == "monomial":
        d = monomial_dictionary()
    else:
        raise ValueError(f"unknown lift kind {lc.kind!r}")
    if lc.zero_offset:
        d = zero_offset(d)
    if lc.state_augmented:
        d = state_augmented(d)
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


def mpc_params(cfg: C.RunConfig, system, nlift: int, device=None
               ) -> MPCParams:
    """Output weight on the tracked outputs (the whole lifted state under
    ``track_lifted``, every state, or one channel with ``cy_index``),
    input weight and box; in du mode the box is du's and
    ``applied_min``/``applied_max`` bound the applied input;
    ``state_bounds`` becomes the stacked (N*py,) ``x_min``/``x_max``; the
    state-space anchor ``ref_state`` under the constant reference; under
    terminal synthesis the lifted-state weight ``q_lift`` of the DARE, the
    whole lifted state under lifted tracking (``Q_Lift = Q``,
    VDP_Revise_2/Koopman_update_Tracking_Lift.m:197), else
    diag(q, ..., q, 0, ...) on the n state channels of the lift
    (``koopmanx/run.py:166-177``)."""
    mc = cfg.mpc
    kw = dict(dtype=torch_dtype(cfg.dtype), device=device)
    if mc.track_lifted:
        py, cy = nlift, None
    elif mc.cy_index is not None:
        py = 1
        cy = torch.zeros((1, system.n), **kw)
        cy[0, mc.cy_index] = 1.0
    else:
        py, cy = system.n, None
    full = lambda v: None if v is None else torch.full((system.m,), v, **kw)
    if mc.delta_u:
        box = (mc.du_min, mc.du_max)
        applied = (mc.applied_min, mc.applied_max)
    else:
        box, applied = (mc.u_min, mc.u_max), (None, None)
    x_box = (None, None)
    if mc.state_bounds is not None:
        x_box = tuple(torch.full((mc.horizon * py,), v, **kw)
                      for v in mc.state_bounds)
    q_lift = None
    if mc.terminal_synthesis:
        diag = torch.zeros((nlift,), **kw)
        diag[: nlift if mc.track_lifted else system.n] = mc.q_weight
        q_lift = torch.diag(diag)
    return MPCParams(
        q_block=mc.q_weight * torch.eye(py, **kw),
        r_block=mc.r_weight * torch.eye(system.m, **kw),
        u_min=full(box[0]),
        u_max=full(box[1]),
        cy=cy,
        applied_min=full(applied[0]),
        applied_max=full(applied[1]),
        q_lift=q_lift,
        x_min=x_box[0],
        x_max=x_box[1],
        ref_state=(_reference_state(cfg, system.n, kw["dtype"], device)
                   if cfg.reference == "constant" else None),
    )


def engine_config(cfg: C.RunConfig) -> EngineConfig:
    """Translate a RunConfig into the static EngineConfig."""
    uc, mc = cfg.update, cfg.mpc
    ecfg = EngineConfig(
        controller=mc.controller,
        horizon=mc.horizon,
        steps=cfg.steps,
        h=cfg.data.h,
        integrator=cfg.integrator,
        delta_u=mc.delta_u,
        applied_bounds=mc.applied_bounds,
        track_lifted=mc.track_lifted,
        update=uc.mode,
        c_pairing=uc.c_pairing,
        rls_lambda=uc.forgetting,
        rls_ridge=uc.ridge,
        symmetrize=uc.symmetrize,
        reset_mult=uc.reset_mult,
        reset_factor=uc.reset_factor,
        window_filter=uc.window_filter,
        window_filter_late=uc.window_filter_late,
        window_filter_warmup=uc.window_filter_warmup,
        window_refit_every=uc.window_refit_every,
        window_carry=uc.window_carry,
        window_polish=uc.window_polish,
        window_anchor=uc.window_anchor,
        dither=uc.dither,
        switch_step=cfg.switch_step,
        markov=mc.markov,
        qp_iters=mc.qp_iters,
        qp_rho=mc.qp_rho,
        qp_kkt_block=mc.qp_kkt_block,
        qp_kkt_lowrank=mc.qp_kkt_lowrank,
        qp_kkt_bf16=mc.qp_kkt_bf16,
        qp_kkt_refine=mc.qp_kkt_refine,
        qp_kkt_reanchor=mc.qp_kkt_reanchor,
        qp_backend=mc.qp_backend,
        terminal_synthesis=mc.terminal_synthesis,
        terminal_mode=mc.terminal_mode,
        state_bounds=mc.state_bounds is not None,
    )
    check_supported(ecfg)
    return ecfg


def ref_fn_for(cfg: C.RunConfig, py: int, device=None,
               dictionary: Optional[Dictionary] = None):
    """The reference window of ``cfg.reference`` over ``py`` channels: the
    constant state reference on the first ``py`` state channels, or under
    ``track_lifted`` lifted through ``dictionary`` (the engine's own, on
    ``device``); the time-varying signals on the first channel."""
    mc = cfg.mpc
    n = get_system(cfg.system).n
    dtype = torch_dtype(cfg.dtype)
    kw = dict(dtype=dtype, device=device)
    if cfg.reference == "constant":
        r_state = _reference_state(cfg, n, dtype, device)
        if mc.track_lifted:
            if dictionary is None:
                raise ValueError("lifted tracking encodes the reference: "
                                 "pass the engine's dictionary")
            base = refgen.constant_state(r_state, mc.horizon, **kw)
            return refgen.encoded(base, dictionary, n)
        value = torch.zeros((py,), **kw)
        k = min(py, n)
        value[:k] = r_state[:k]
        return refgen.constant(value, mc.horizon, py, **kw)
    if cfg.reference == "sine":
        return refgen.sine(cfg.reference_value, 0.01, mc.horizon, py, **kw)
    if cfg.reference == "square":
        return refgen.square(cfg.reference_value, 200, mc.horizon, py, **kw)
    if cfg.reference == "chirp":
        return refgen.chirp(cfg.reference_value, mc.horizon, py, **kw)
    if cfg.reference == "cos_sin_mix":
        return refgen.cos_sin_mix(0.5, 0.007, 1.2, 0.002, mc.horizon, py,
                                  **kw)
    raise ValueError(f"unknown reference {cfg.reference!r}")


_STORE = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def store_dtype(cfg: C.RunConfig) -> Optional[torch.dtype]:
    """The ring's storage dtype: None (the run's own dtype) for
    ``window_store='float32'``, as in the JAX package, else bfloat16 or
    float16."""
    name = cfg.update.window_store
    if name == "float32":
        return None
    if name not in _STORE:
        raise ValueError(f"unknown window_store {name!r}")
    return _STORE[name]


def initial_estimator(cfg: C.RunConfig, dictionary: Dictionary,
                      data: Snapshots):
    """One scenario's estimator state (``koopmanx/run.py:350-387``): for
    ``update.mode='windowed'`` a ring (in ``window_store``) prefilled with
    the last W lifted training snapshots, with the Woodbury lane's
    statistics built from it; for ``'storage'`` the Grams of the lifted
    training snapshots; else the square-root (``'rls_sqrt'``), Gram-carry
    (``'rls_chol'``) or SM RLS (the rest, ``'off'`` included, as in the
    JAX package), warm-started from those Grams under
    ``warm_start_from_batch`` (``Revise_2/Koopman_update.m:264-265``), else
    from its scaled-identity prior."""
    system = get_system(cfg.system)
    uc = cfg.update
    dtype = torch_dtype(cfg.dtype)
    if uc.mode == "windowed":
        state = window_init(uc.window, dictionary.nlift, system.m, system.n,
                            dtype, carry=uc.window_carry == "woodbury",
                            ridge=max(uc.ridge, 1e-5),
                            store_dtype=store_dtype(cfg))
        return window_prefill(state, dictionary(data.x), data.u,
                              dictionary(data.y), data.x)
    if uc.mode == "storage" or uc.warm_start_from_batch:
        stats = gram_stats(dictionary(data.x), dictionary(data.y), data.u,
                           data.x)
        init = {"storage": storage_init, "rls_sqrt": sqrt_rls_init_from_grams,
                "rls_chol": gram_rls_init_from_grams}.get(
            uc.mode, rls_init_from_grams)
        return init(stats)
    init = {"rls_sqrt": sqrt_rls_init, "rls_chol": gram_rls_init}.get(
        uc.mode, rls_init)
    return init(dictionary.nlift, system.m, system.n, uc.c_ab, uc.c_c, dtype)


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
        rls0 = initial_estimator(cfg, dictionary, data)
    if x_init is None:
        x_init = cfg.x0 if cfg.x0 is not None else (
            (system.x_init,) * system.n)
    x_init = torch.as_tensor(x_init, dtype=dtype)

    to = lambda tree: type(tree)(*(None if t is None else t.to(dev)
                                   for t in tree))
    dictionary = dictionary.to(dev)
    params = mpc_params(cfg, system, dictionary.nlift, dev)
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
            ref_fn_for(cfg, params.q_block.shape[0], dev, dictionary),
        ),
        x_init=x_init.to(dev),
        device=dev,
    )


def build_local_linear(cfg: C.RunConfig, device: DeviceLike = None):
    """The local-linearization baseline of a run config
    (:mod:`.engine.local_linear`): ``(closed_loop, params)`` on ``device``
    (None means CUDA), with the config's MPC weights, box and reference on
    the affine lift psi(x) = [x; 1]. No data, lift or estimator: the model
    is the plant's Jacobian every step."""
    dev = resolve_device(device)
    system = get_system(cfg.system)
    dictionary = constant_augmented(system.n)
    params = mpc_params(cfg, system, dictionary.nlift, dev)
    loop = make_local_linear_loop(
        system, engine_config(cfg),
        ref_fn_for(cfg, params.q_block.shape[0], dev, dictionary))
    return loop, params


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


def _as_batch_of_one(pipe: Pipeline):
    """The pipeline's loop arguments with a scenario axis of one."""
    return (replicate(pipe.params, 1), pipe.x_init.unsqueeze(0),
            replicate(pipe.model0, 1), replicate(pipe.rls0, 1))


def _squeeze(tree):
    return tree_map(lambda t: t[0], tree)


def run_single(pipe: Pipeline, theta0=None, theta1=None):
    """Run the pipeline's one scenario from ``x_init``; returns (LoopCarry,
    StepLog) without the scenario axis (the log is (T, ...))."""
    carry, log = run_batch(pipe.closed_loop, *_as_batch_of_one(pipe),
                           theta0, theta1)
    return _squeeze(carry), _squeeze(log)


def with_engine_config(pipe: Pipeline, **changes) -> Pipeline:
    """``pipe`` with the fields ``changes`` of its ``EngineConfig``
    replaced and its closed loop rebuilt on them (e.g. ``remat=True``, or
    another ``steps``), as the JAX package rebuilds ``make_closed_loop``
    on ``dataclasses.replace(pipe.engine_cfg, ...)``."""
    cfg = dataclasses.replace(pipe.engine_cfg, **changes)
    loop = make_closed_loop(
        get_system(pipe.config.system), pipe.dictionary, cfg,
        ref_fn_for(pipe.config, pipe.params.q_block.shape[-1], pipe.device,
                   pipe.dictionary))
    return pipe._replace(engine_cfg=cfg, closed_loop=loop)


def run_resumable(pipe: Pipeline, total_steps: int, chunk_steps: int,
                  checkpoint_path: Optional[str] = None,
                  resume: bool = False):
    """:func:`run_single` in chunks of ``chunk_steps``, the carry handed
    from each chunk to the next and, with ``checkpoint_path``, saved after
    each (``eval.persist.save_pytree``, with the next chunk's first step).
    ``resume=True`` starts from that checkpoint where it exists. Returns
    (LoopCarry, StepLog) of the chunks run, without the scenario axis, the
    logs joined along time."""
    from .eval.persist import load_pytree, save_pytree

    loop = with_engine_config(pipe, steps=chunk_steps).closed_loop
    args = _as_batch_of_one(pipe)
    carry, start = None, 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        carry, start = load_pytree(checkpoint_path, loop.initial_carry(*args))
    logs = []
    for offset in range(start, total_steps, chunk_steps):
        carry, log = loop(*args, carry0=carry, step_offset=offset)
        logs.append(log)
        if checkpoint_path:
            save_pytree(checkpoint_path, carry, meta=offset + chunk_steps)
    log = tree_map(lambda *parts: torch.cat(parts, dim=1), *logs)
    return _squeeze(carry), _squeeze(log)
