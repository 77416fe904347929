"""Build the port's pipeline from plain numpy arrays.

The arrays carry a pipeline across from any source; the tests take them
from the JAX pipeline with ``jax.tree_util.tree_map(np.asarray, ...)``.
This module imports no JAX. ``arrays`` is a dict:

- the base lift, one of
  - ``"mlp"``: ``[(W, b), ...]``, W in the (out, in) convention, or the
    path of a ``.mat`` or ``.pkl`` weights file (``run.load_mlp_weights``);
  - ``"rbf"``: ``{"centers": (K, n), "kind": str}``;
  - ``"fourier"``: ``{"w": (D, n), "b": (D,)}``;
  - ``"hermite"``: ``{"degree": int, "reference_quirk": bool}``;
  - ``"monomial"`` or ``"identity"``: True (no parameters);
- ``"state_augmented"``, ``"zero_offset"`` (optional, default False): the
  wrappers of ``lifts/base.py`` around the base lift, as ``LiftConfig``
  names them (``zero_offset`` inside ``state_augmented`` when both);
- ``"normalizer"``: ``(mu, sc)``, or absent/None for an un-normalized lift;
- ``"model0"``: ``(A, B, C)``;
- ``"rls0"``: the estimator state's fields by name, which pick its type:
  ``{"zx", "u", "zy", "x", "idx"}`` (the windowed estimator's rings
  and cursor) with, in the Woodbury lane, ``"g"``, ``"g_inv"``, ``"gz"``,
  ``"gz_inv"``, ``"mg"``, ``"mc"`` (absent keys, or None, stay None);
  ``{"K_A", "invG", "barX", "barQ"}`` (SM RLS); ``{"syv", "gvv", "sxz",
  "gzz"}`` (storage); ``{"K_A", "g", "barX", "q"}`` (Gram-carry RLS);
  ``{"K_A", "r_g", "barX", "r_q", "count"}`` (square-root RLS). The
  rings are cast to the config's ``window_store`` dtype: numpy has no
  bfloat16, so a compressed ring arrives in float32 and is cast back,
  which is exact for values the storage dtype holds;
- ``"params"``: ``{"q_block", "r_block", "u_min", "u_max"}`` and optionally
  ``"cy"``, ``"applied_min"``, ``"applied_max"``, ``"terminal"``,
  ``"q_lift"`` (the terminal synthesis's lifted weight), ``"x_min"``,
  ``"x_max"`` and ``"ref_state"`` (the ``MPCParams`` arrays);
- ``"x_init"`` (optional): the initial plant state; the plant's default
  (``System.x_init`` on every channel) where absent.

:func:`controller_state_from_numpy` carries a serving controller's state
across the same way (``engine/controller.py::ControllerState``'s fields
by name), so that the port's controller can go on from a JAX
controller's state mid-run.

:func:`kmae_state_from_numpy` and :func:`kmae_state_to_numpy` carry a
KMAE training state across (``train/state.py`` holds them and the
checkpoint schema; they are re-exported here).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from . import configs as C
from .device import DeviceLike, resolve_device
from .edmd.rls import GramRLSState, SqrtRLSState, StorageState
from .edmd.windowed import WindowState
from .engine.controller import ControllerState
from .engine.core import MPCParams
from .engine.loop import make_closed_loop
from .lifts.base import (
    Dictionary,
    StateAugmented,
    ZeroOffset,
    identity_dictionary,
    state_augmented,
    zero_offset,
)
from .lifts.fourier import RFF, fourier_dictionary
from .lifts.mlp import MLP, encoder_dictionary
from .lifts.poly import (
    Hermite,
    Monomial,
    hermite_dictionary,
    monomial_dictionary,
)
from .lifts.rbf import RBF, rbf_dictionary
from .run import (
    Pipeline,
    engine_config,
    load_mlp_weights,
    ref_fn_for,
    store_dtype,
)
from .systems.library import get_system
from .train.state import (
    kmae_arrays_from_leaves,
    kmae_leaves,
    kmae_state_from_numpy,
    kmae_state_to_numpy,
    load_kmae_numpy,
)
from .tree import host_numpy, tree_map
from .types import LinearModel, RLSState

_INT = {"count", "idx"}
_RINGS = {"zx", "u", "zy", "x"}
# each estimator state with a field that no state before it in the list has
_STATES = ((WindowState, "zx"), (RLSState, "invG"), (StorageState, "syv"),
           (GramRLSState, "q"), (SqrtRLSState, "r_g"))


def _state_class(fields: Dict[str, Any]):
    for cls, key in _STATES:
        if fields.get(key) is not None:
            return cls
    raise ValueError(f"no estimator state has the fields {sorted(fields)}")


def _estimator_from_numpy(r: Dict[str, Any], cfg: C.RunConfig, leaf):
    state_cls = _state_class(r)
    state = state_cls(**{k: leaf(k, r[k]) for k in state_cls._fields
                         if r.get(k) is not None})
    store = store_dtype(cfg)
    if state_cls is WindowState and store is not None:
        state = state._replace(**{k: getattr(state, k).to(store)
                                  for k in _RINGS})
    return state


def pipeline_from_numpy(arrays: Dict[str, Any], cfg: C.RunConfig,
                        device: DeviceLike = None,
                        dtype: torch.dtype = torch.float32) -> Pipeline:
    dev = resolve_device(device)
    t = lambda a: torch.tensor(np.array(a), dtype=dtype, device=dev)
    leaf = lambda k, a: (torch.tensor(np.array(a), dtype=torch.int32,
                                      device=dev) if k in _INT else t(a))
    system = get_system(cfg.system)

    if "rbf" in arrays:
        rbf = arrays["rbf"]
        dictionary = rbf_dictionary(t(rbf["centers"]), rbf["kind"])
    elif "fourier" in arrays:
        rff = arrays["fourier"]
        dictionary = fourier_dictionary(t(rff["w"]), t(rff["b"]))
    elif "hermite" in arrays:
        dictionary = hermite_dictionary(**arrays["hermite"])
    elif arrays.get("monomial"):
        dictionary = monomial_dictionary()
    elif arrays.get("identity"):
        dictionary = identity_dictionary(system.n)
    else:
        weights = arrays["mlp"]
        if isinstance(weights, str):
            weights = load_mlp_weights(weights, dtype)
            if weights is None:
                raise ValueError(f"{arrays['mlp']!r}: MLP weights are a "
                                 ".mat or .pkl file")
        mlp = MLP.from_params([(t(w), t(b)) for w, b in weights])
        dictionary = encoder_dictionary(mlp, n=system.n)
    if arrays.get("zero_offset"):
        dictionary = zero_offset(dictionary)
    if arrays.get("state_augmented"):
        dictionary = state_augmented(dictionary)
    if arrays.get("normalizer") is not None:
        mu, sc = arrays["normalizer"]
        dictionary = Dictionary(dictionary.encoder, dictionary.nlift,
                                system.n, t(mu), t(sc))
    dictionary = dictionary.to(dev)

    a, b, c = arrays["model0"]
    model0 = LinearModel(A=t(a), B=t(b), C=t(c))
    rls0 = _estimator_from_numpy(arrays["rls0"], cfg, leaf)
    p = arrays["params"]
    opt = lambda k: None if p.get(k) is None else t(p[k])
    params = MPCParams(
        q_block=t(p["q_block"]), r_block=t(p["r_block"]),
        u_min=t(p["u_min"]), u_max=t(p["u_max"]), cy=opt("cy"),
        applied_min=opt("applied_min"), applied_max=opt("applied_max"),
        terminal=opt("terminal"), q_lift=opt("q_lift"), x_min=opt("x_min"),
        x_max=opt("x_max"), ref_state=opt("ref_state"),
    )
    x_init = arrays.get("x_init")
    x_init = t((system.x_init,) * system.n if x_init is None else x_init)

    engine_cfg = engine_config(cfg)
    return Pipeline(
        config=cfg,
        dictionary=dictionary,
        data=None,
        model0=model0,
        rls0=rls0,
        engine_cfg=engine_cfg,
        params=params,
        closed_loop=make_closed_loop(
            system, dictionary, engine_cfg,
            ref_fn_for(cfg, params.q_block.shape[-1], dev, dictionary),
        ),
        x_init=x_init,
        device=dev,
    )


def pipeline_to_numpy(pipe: Pipeline) -> Dict[str, Any]:
    """The inverse of :func:`pipeline_from_numpy` (for round trips)."""
    n = host_numpy

    d = pipe.dictionary
    arrays = {"normalizer": (n(d.mu), n(d.sc)) if d.is_normalized else None}
    enc = d.encoder
    if isinstance(enc, StateAugmented):
        arrays["state_augmented"] = True
        enc = enc.inner.encoder
    if isinstance(enc, ZeroOffset):
        arrays["zero_offset"] = True
        enc = enc.inner.encoder
    if isinstance(enc, RBF):
        arrays["rbf"] = {"centers": n(enc.centers), "kind": enc.kind}
    elif isinstance(enc, RFF):
        arrays["fourier"] = {"w": n(enc.w), "b": n(enc.b)}
    elif isinstance(enc, Hermite):
        arrays["hermite"] = {"degree": enc.degree,
                             "reference_quirk": enc.reference_quirk}
    elif isinstance(enc, Monomial):
        arrays["monomial"] = True
    elif isinstance(enc, nn.Identity):
        arrays["identity"] = True
    else:
        arrays["mlp"] = [(n(w), n(b)) for w, b in enc.params()]
    arrays.update({
        "model0": tuple(n(x) for x in pipe.model0),
        "rls0": {k: None if v is None else n(v)
                 for k, v in pipe.rls0._asdict().items()},
        "params": {k: None if v is None else n(v)
                   for k, v in pipe.params._asdict().items()},
        "x_init": n(pipe.x_init),
    })
    return arrays


def _absent(v) -> bool:
    return v is None or (isinstance(v, tuple) and not v)


def controller_state_from_numpy(arrays: Dict[str, Any], cfg: C.RunConfig,
                                device: DeviceLike = None,
                                dtype: torch.dtype = torch.float32
                                ) -> ControllerState:
    """A ``ControllerState`` from numpy arrays under its field names:
    ``"model"`` (A, B, C), ``"rls"`` (the estimator's fields, as
    ``"rls0"`` above), ``"u_prev"``, ``"warm_x"``, ``"warm_y"`` (None or
    absent without the 'full' warm start), ``"z_prev"``, ``"x_prev"``,
    ``"have_prev"``, ``"res_ema"`` and ``"cert"`` ((P, K, gamma) of the
    DARE or LMI terminal, or None or absent without terminal synthesis,
    as in LQR mode) and ``"kkt_inv"`` (the carried KKT inverse under
    ``qp_kkt_refine``, or None or absent). A fleet's arrays carry the
    plant axis first; a single controller's (``have_prev`` a scalar) get
    a plant axis of one."""
    dev = resolve_device(device)
    single = np.ndim(arrays["have_prev"]) == 0
    add_axis = (lambda a: np.asarray(a)[None]) if single else np.asarray
    t = lambda a: torch.tensor(add_axis(a), dtype=dtype, device=dev)
    leaf = lambda k, a: (torch.tensor(add_axis(a), dtype=torch.int32,
                                      device=dev) if k in _INT else t(a))
    opt = lambda k, make: (() if _absent(arrays.get(k))
                           else make(arrays[k]))
    return ControllerState(
        model=LinearModel(*(t(a) for a in arrays["model"])),
        rls=_estimator_from_numpy(arrays["rls"], cfg, leaf),
        u_prev=t(arrays["u_prev"]),
        warm_x=t(arrays["warm_x"]),
        warm_y=opt("warm_y", t),
        z_prev=t(arrays["z_prev"]),
        x_prev=t(arrays["x_prev"]),
        have_prev=torch.tensor(add_axis(arrays["have_prev"]),
                               dtype=torch.bool, device=dev),
        res_ema=t(arrays["res_ema"]),
        cert=opt("cert", lambda c: tuple(t(a) for a in c)),
        kkt_inv=opt("kkt_inv", t),
    )


def controller_state_to_numpy(state: ControllerState) -> Dict[str, Any]:
    """The inverse of :func:`controller_state_from_numpy`, plant axis
    kept; ``()`` parts come back as None."""
    n = lambda tree: tree_map(host_numpy, tree)
    return {
        "model": tuple(n(state.model)),
        "rls": {k: n(v) for k, v in state.rls._asdict().items()},
        **{k: n(getattr(state, k)) for k in (
            "u_prev", "warm_x", "z_prev", "x_prev", "have_prev", "res_ema")},
        "warm_y": n(state.warm_y) if isinstance(state.warm_y, torch.Tensor)
        else None,
        "cert": None if _absent(state.cert) else n(state.cert),
        "kkt_inv": None if _absent(state.kkt_inv) else n(state.kkt_inv),
    }
