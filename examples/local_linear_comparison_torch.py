"""The reference's local-linearization MPC baseline, closed and A/B'd, on
the PyTorch port (the counterpart of
``examples/local_linear_comparison.py``).

``duffing.py:691-706`` (sympy Jacobian) and ``Revise_2/Koopman_update.m:
169-177`` (MATLAB ``jacobian``) stage a locally-linear MPC comparison
against the Koopman controller but never close the loop. This example
runs both on the SAME Duffing tracking scenario through the SAME condensed
QP (the local model rides the affine lift psi(x) = [x; 1], see
``koopmanx_torch/engine/local_linear.py``) and overlays them.

Run:  python examples/local_linear_comparison_torch.py [--steps 400] [--cpu]
On the card (the default) both loops' box QPs run in the box-ADMM kernel,
one launch a step each; with ``--cpu`` on the plain route on the CPU.
Outputs: local_linear_comparison.png, the printed MSEs and the kernel's
launches. Imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from koopmanx_torch import configs as C  # noqa: E402
from koopmanx_torch.device import default_qp_backend  # noqa: E402
from koopmanx_torch.engine.local_linear import run_local_linear_batch  # noqa: E402
from koopmanx_torch.eval.metrics import steady_state_error, tracking_mse  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import (  # noqa: E402
    build_local_linear,
    build_pipeline,
    replicate,
    run_single,
)

NAMES = ("koopman", "local_linear")


def config(steps: int = 400, switch: int = 10**9,
           qp_backend: str = "pallas") -> C.RunConfig:
    """The shipped duffing preset, ``steps`` long, the plant switch at
    ``switch``, the box QP on ``qp_backend``: the Koopman loop's, and the
    plant, weights, box and reference of the local-linear loop."""
    cfg = C.duffing_nn_preset()
    cfg.steps = steps
    cfg.switch_step = switch
    cfg.mpc.qp_backend = qp_backend
    return cfg


def loop_metrics(log) -> dict:
    """Tracking MSE of x1, steady-state error and max |u| of one
    scenario's log (T, ...)."""
    x1, r1 = log.x[:, 0].cpu(), log.r[:, 0].cpu()
    return dict(mse=float(tracking_mse(x1, r1)),
                sse=float(steady_state_error(x1, r1)),
                u_abs_max=float(log.u.abs().max()))


def compare(steps: int = 400, switch: int = 10**9, device=None) -> dict:
    """The Koopman loop and the local-linear loop, one scenario from the
    preset's x_init, on ``device`` (None: the card; the kernel route
    there, the plain one on the CPU). Returns ``logs`` and ``metrics``
    (:func:`loop_metrics`) by loop and the box-ADMM ``launches`` of the
    two runs."""
    cfg = config(steps, switch, default_qp_backend(device))
    before = box_admm.launches
    pipe = build_pipeline(cfg, device=device)
    _, log_koop = run_single(pipe)
    loop, params = build_local_linear(cfg, device=device)
    _, log_ll = run_local_linear_batch(loop, replicate(params, 1),
                                       pipe.x_init.unsqueeze(0))
    logs = dict(koopman=log_koop,
                local_linear=type(log_ll)(*(t[0] for t in log_ll)))
    return dict(logs=logs,
                metrics={k: loop_metrics(v) for k, v in logs.items()},
                launches=box_admm.launches - before)


def figure(result: dict, out: str) -> None:
    """The overlay of both loops (matplotlib; raises where it is not
    installed)."""
    from koopmanx_torch.eval.plots import tracking

    logs = result["logs"]
    ax = tracking(logs["koopman"].x, logs["koopman"].r, h=0.05,
                  x_compare=logs["local_linear"].x,
                  labels=("Koopman MPC", "local-linearization MPC"))
    ax.figure.savefig(out, dpi=130)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--switch", type=int, default=10**9)
    ap.add_argument("--out", default="local_linear_comparison.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    result = compare(args.steps, args.switch,
                     device="cpu" if args.cpu else None)
    for name in NAMES:
        m = result["metrics"][name]
        print(f"{name:>13}: tracking MSE = {m['mse']:.6f}  "
              f"|u|max = {m['u_abs_max']:.3f}")
    print(f"box-ADMM kernel launches: {result['launches']}")
    figure(result, args.out)
    print(f"wrote {args.out}")
    return result["metrics"]


if __name__ == "__main__":
    main()
