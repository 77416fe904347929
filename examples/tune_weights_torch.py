"""Gradient-tune the MPC input weight THROUGH the closed loop, on the
PyTorch port (the counterpart of ``examples/tune_weights.py``).

The port's closed loop (encode, condensed-QP build, 60 fixed ADMM
iterations, plant step, online square-root RLS) records the autograd graph
when one of its inputs requires grad, so ``torch.autograd.grad`` gives the
derivative of the realized tracking cost with respect to ``log r`` and a
few Adam steps tune R against the TRUE nonlinear plant. The QP runs on the
plain route (``qp_backend='xla'``): the box-ADMM kernel has no gradient,
as the JAX package's Pallas route has none. ``--remat`` sets
``EngineConfig.remat``: each step is recomputed in the backward pass
instead of keeping its activations.

  python examples/tune_weights_torch.py            # on the card
  python examples/tune_weights_torch.py --cpu      # on the CPU

Prints as the JAX example does: r and the settled cost before, every third
Adam step (r, the cost and the gradient before the step) and after. Imports
no JAX.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from koopmanx_torch import configs as C  # noqa: E402
from koopmanx_torch.engine.loop import run_batch  # noqa: E402
from koopmanx_torch.run import (  # noqa: E402
    build_pipeline,
    replicate,
    with_engine_config,
)

LR = 0.5  # Adam's step, as the JAX example's optax.adam(0.5)


def tune_config(steps: int = 200, dtype: str = "float32") -> C.RunConfig:
    """The JAX example's configuration: the flagship preset, 40 x 40
    training data, r deliberately detuned to 1.0 (the reference's is
    1e-4), the plain QP route."""
    cfg = C.duffing_nn_preset()
    cfg.steps = steps
    cfg.dtype = dtype
    cfg.data = C.DataConfig(n_step=40, n_traj=40)
    cfg.mpc.r_weight = 1.0
    cfg.mpc.qp_backend = "xla"
    return cfg


def settled_cost(pipe, log_r):
    """The mean squared tracking error of x1 over the second half of the
    run (the first half is the transit from x0, the same for any sane R),
    with ``r_block = exp(log_r) I`` so that r stays positive."""
    r_block = torch.exp(log_r) * torch.eye(
        1, dtype=log_r.dtype, device=log_r.device)
    params = replicate(pipe.params._replace(r_block=r_block), 1)
    _, log = run_batch(pipe.closed_loop, params, pipe.x_init.unsqueeze(0),
                       replicate(pipe.model0, 1), replicate(pipe.rls0, 1))
    err = log.x[0, :, 0] - log.r[0, :, 0]
    return (err[pipe.engine_cfg.steps // 2:] ** 2).mean()


def tune(cfg: C.RunConfig, iters: int = 15, device=None, pipe=None,
         remat: bool = False):
    """``iters`` Adam steps on ``log r`` from 0, through ``cfg``'s pipeline
    on ``device`` (None: the card), or through ``pipe`` where given.
    Returns one record a step: ``log_r`` and ``r`` after it, the ``cost``
    and ``grad`` it was taken on, and its ``ms``."""
    if pipe is None:
        pipe = build_pipeline(cfg, device=device)
    if remat:
        pipe = with_engine_config(pipe, remat=True)
    log_r = torch.zeros((), dtype=pipe.x_init.dtype, device=pipe.device,
                        requires_grad=True)
    opt = torch.optim.Adam([log_r], lr=LR)
    trajectory = []
    for i in range(iters):
        t0 = time.perf_counter()
        cost = settled_cost(pipe, log_r)
        (grad,) = torch.autograd.grad(cost, log_r)
        log_r.grad = grad
        opt.step()
        value = log_r.detach()
        trajectory.append(dict(iter=i + 1, log_r=float(value),
                               r=float(torch.exp(value)),
                               cost=float(cost.detach()), grad=float(grad),
                               ms=(time.perf_counter() - t0) * 1e3))
    return trajectory


def forward_cost(pipe, log_r: float) -> float:
    """The settled cost at ``log_r`` without a graph."""
    with torch.inference_mode():
        return float(settled_cost(pipe, torch.tensor(
            log_r, dtype=pipe.x_init.dtype, device=pipe.device)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    cfg = tune_config(args.steps)
    pipe = build_pipeline(cfg, device="cpu" if args.cpu else None)
    print(f"init: r={1.0:.2e} cost={forward_cost(pipe, 0.0):.5f}")
    trajectory = tune(cfg, args.iters, pipe=pipe, remat=args.remat)
    for rec in trajectory:
        if rec["iter"] % 3 == 0:
            print(f"step {rec['iter']:2d}: r={rec['r']:.2e} "
                  f"cost={rec['cost']:.5f} grad={rec['grad']:+.4f}")
    log_r = trajectory[-1]["log_r"] if trajectory else 0.0
    r = trajectory[-1]["r"] if trajectory else 1.0
    print(f"tuned: r={r:.2e} cost={forward_cost(pipe, log_r):.5f}")
    return trajectory


if __name__ == "__main__":
    main()
