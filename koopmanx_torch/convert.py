"""Build the port's pipeline from plain numpy arrays.

The arrays carry a pipeline across from any source; the tests take them
from the JAX pipeline with ``jax.tree_util.tree_map(np.asarray, ...)``.
This module imports no JAX. ``arrays`` is a dict:

- ``"mlp"``: ``[(W, b), ...]``, W in the (out, in) convention;
- ``"normalizer"``: ``(mu, sc)``, or absent/None for an un-normalized lift;
- ``"model0"``: ``(A, B, C)``;
- ``"rls0"``: ``{"K_A", "r_g", "barX", "r_q", "count"}`` (square-root RLS);
- ``"params"``: ``{"q_block", "r_block", "u_min", "u_max"}`` and optionally
  ``"cy"`` and ``"ref_state"`` (the ``MPCParams`` arrays);
- ``"x_init"`` (optional): the initial plant state.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import configs as C
from .device import DeviceLike, resolve_device
from .edmd.rls import SqrtRLSState
from .engine.core import MPCParams
from .lifts.base import Dictionary
from .lifts.mlp import MLP, encoder_dictionary
from .run import Pipeline, engine_config, ref_fn_for
from .engine.loop import make_closed_loop
from .systems.library import get_system
from .types import LinearModel


def pipeline_from_numpy(arrays: Dict[str, Any], cfg: C.RunConfig,
                        device: DeviceLike = None,
                        dtype: torch.dtype = torch.float32) -> Pipeline:
    dev = resolve_device(device)
    t = lambda a: torch.tensor(np.array(a), dtype=dtype, device=dev)
    system = get_system(cfg.system)

    mlp = MLP.from_params([(t(w), t(b)) for w, b in arrays["mlp"]])
    dictionary: Dictionary = encoder_dictionary(mlp, n=system.n)
    if arrays.get("normalizer") is not None:
        mu, sc = arrays["normalizer"]
        dictionary = Dictionary(mlp, dictionary.nlift, system.n, t(mu), t(sc))
    dictionary = dictionary.to(dev)

    a, b, c = arrays["model0"]
    model0 = LinearModel(A=t(a), B=t(b), C=t(c))
    r = arrays["rls0"]
    rls0 = SqrtRLSState(
        K_A=t(r["K_A"]), r_g=t(r["r_g"]), barX=t(r["barX"]), r_q=t(r["r_q"]),
        count=torch.tensor(np.array(r["count"]), dtype=torch.int32,
                           device=dev),
    )
    p = arrays["params"]
    params = MPCParams(
        q_block=t(p["q_block"]), r_block=t(p["r_block"]),
        u_min=t(p["u_min"]), u_max=t(p["u_max"]),
        cy=None if p.get("cy") is None else t(p["cy"]),
        ref_state=None if p.get("ref_state") is None else t(p["ref_state"]),
    )
    x_init = arrays.get("x_init")
    x_init = t(np.full((system.n,), -2.0) if x_init is None else x_init)

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
            ref_fn_for(cfg, params.q_block.shape[-1], dev),
        ),
        x_init=x_init,
        device=dev,
    )


def pipeline_to_numpy(pipe: Pipeline) -> Dict[str, Any]:
    """The inverse of :func:`pipeline_from_numpy` (for round trips)."""
    n = lambda x: x.detach().cpu().numpy()
    d = pipe.dictionary
    arrays = {
        "mlp": [(n(w), n(b)) for w, b in d.encoder.params()],
        "normalizer": (n(d.mu), n(d.sc)) if d.is_normalized else None,
        "model0": tuple(n(x) for x in pipe.model0),
        "rls0": {k: n(v) for k, v in pipe.rls0._asdict().items()},
        "params": {k: None if v is None else n(v)
                   for k, v in pipe.params._asdict().items()},
        "x_init": n(pipe.x_init),
    }
    return arrays
