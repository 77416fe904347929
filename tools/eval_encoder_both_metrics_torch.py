#!/usr/bin/env python
"""Score encoder artifacts on both reference-comparable metrics with the
PyTorch port (counterpart of ``tools/eval_encoder_both_metrics.py``).

The open-loop champion is not the closed-loop champion, so each encoder
``.mat`` (and the reference's shipped weights, where present) is scored on:

  open_rmse   the reference's 500-step open-loop prediction RMSE
              (duffing.py:264-344: the pinv EDMD fit on 100 x 100
              snapshots from seed 0, the replay on the seed-2 rollout,
              both on the CPU as build_pipeline's setup runs)
  closed_sse  the steady-state tracking error of the production closed
              loop (the CLI summary metric, |tail-mean(y) - target|; 300
              steps in float32, duffing r = 1, vanderpol output tracking
              r = 1), run by ``run.run_single`` on the card through the
              box-ADMM kernel (one launch a step; the plain route with
              ``--cpu``)

  python tools/eval_encoder_both_metrics_torch.py --system duffing \\
      --artifacts artifacts/duffing_kmae_r3a_encoder.mat,... [--cpu]

The snapshots are the port's generators' draws from the JAX tool's seeds,
not the JAX tool's own; ``openloop_rmse`` takes snapshots as arguments
for that reason. One JSON line per artifact, with the JAX tool's keys.
It runs on the card unless ``--cpu`` is given and raises without one. It
imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from train_reference_scale_torch import (  # noqa: E402
    REF_WEIGHTS,
    openloop_rmse_host,
)

# tools/eval_encoder_both_metrics.py:107-116: the artifacts scored by
# default, by their tag
DEFAULT_TAGS = {
    "duffing": ["", "_r3a", "_r3b", "_r3c", "_r3d", "_refscale"],
    "vanderpol": ["", "_vdp_r30", "_vdp_r31", "_refscale"],
}


def default_artifacts(system: str):
    return [os.path.join(ROOT, "artifacts", f"{system}_kmae{t}_encoder.mat")
            for t in DEFAULT_TAGS[system]]


def protocol_snapshots(system):
    """The protocol's training snapshots (seed 0, 100 x 100) and test
    rollout (seed 2, 500 steps) from the port's generators."""
    from koopmanx_torch.systems.data import collect

    gen = lambda seed: torch.Generator().manual_seed(seed)
    return (collect(system, gen(0), n_step=100, n_traj=100),
            collect(system, gen(2), n_step=500, n_traj=1))


def openloop_rmse(system, weights_path: str, data=None, val=None) -> float:
    """The reference's open-loop RMSE formula of the encoder at
    ``weights_path`` (float32), fitted on ``data`` and replayed over
    ``val`` (default: :func:`protocol_snapshots`), on the CPU."""
    from koopmanx_torch.lifts.io import load_mat_mlp
    from koopmanx_torch.lifts.mlp import MLP, encoder_dictionary

    if data is None or val is None:
        data, val = protocol_snapshots(system)
    d = encoder_dictionary(MLP.from_params(load_mat_mlp(weights_path)),
                           n=system.n)
    return openloop_rmse_host(d, data, val)[0]


def closed_loop_config(system_name: str, weights_path: str, steps: int,
                       device):
    """The production loop's config under this encoder
    (``tools/eval_encoder_both_metrics.py:62-79``), on ``device``'s
    route."""
    from koopmanx_torch import configs as C
    from koopmanx_torch.device import default_qp_backend

    if system_name == "duffing":
        cfg = C.duffing_nn_preset()
    else:
        # output-tracking VDP (the encoder-robust formulation, see
        # vanderpol_selftrained_preset)
        cfg = C.vdp_lifted_preset()
        cfg.mpc.track_lifted = False
        cfg.data.u_range = (-6.0, 6.0)
    cfg.steps = steps
    cfg.dtype = "float32"
    # absolute: the port resolves a relative path against the repo root
    cfg.lift.weights_path = os.path.abspath(weights_path)
    cfg.mpc.qp_backend = default_qp_backend(device)
    return cfg


def closed_metrics(log, steps: int):
    """(steady-state error, max |u|, finite) of a single run's log: the
    JAX tool's formula, in the log's dtype."""
    x, r, u = (t.cpu().numpy() for t in (log.x, log.r, log.u))
    tail = slice(-max(steps // 10, 20), None)
    target = r[-1, 0]
    return (float(abs(x[tail, 0].mean() - target)),
            float(np.abs(u).max()), bool(np.isfinite(x).all()))


def closed_sse(system_name: str, weights_path: str, steps: int = 300,
               device=None):
    """:func:`closed_metrics` of the production closed loop under this
    encoder (the CLI summary metric on the flagship scenario) on
    ``device`` (None: the card)."""
    from koopmanx_torch.run import build_pipeline, run_single

    cfg = closed_loop_config(system_name, weights_path, steps, device)
    _, log = run_single(build_pipeline(cfg, device=device))
    return closed_metrics(log, steps)


def main(argv=None):
    """Score each artifact; print one JSON line each and return them."""
    from koopmanx_torch.device import resolve_device
    from koopmanx_torch.systems.library import get_system

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--system", default="duffing")
    ap.add_argument("--artifacts", default="")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    system = get_system(args.system)
    paths = ([p for p in args.artifacts.split(",") if p]
             or default_artifacts(args.system))
    ref = os.path.join(ROOT, REF_WEIGHTS[args.system])
    if os.path.isfile(ref):
        paths.append(ref)

    data, val = protocol_snapshots(system)
    rows = []
    for p in paths:
        if not os.path.exists(p):
            row = {"artifact": p, "error": "missing"}
        else:
            o = openloop_rmse(system, p, data, val)
            c, umax, finite = closed_sse(args.system, p, args.steps, device)
            row = {"artifact": os.path.basename(p),
                   "open_rmse": round(o, 5),
                   "closed_sse": round(c, 5),
                   "u_abs_max": round(umax, 3),
                   "finite": finite}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
