"""The Tank serve loop (Tank_System.m) on the PyTorch port (the
counterpart of ``examples/tank_delta_u.py``): du (incremental)
condensed-QP MPC with the sliding-window online estimator, tracking tank-2
level r = 1 through the coefficient switch at step 100
(0.5/0.4/0.2/0.3 -> 0.53/0.3/0.1/0.35, Tank_System.m:193-203). The
reference rebuilds F1/F2/H every step after the RLS update (:272-290);
here the rebuild runs inside each step of the loop.

Run:  python examples/tank_delta_u_torch.py [--steps 1200] [--cpu]
On the card (the default) the box QP of every step runs in the box-ADMM
kernel, one launch a step; with ``--cpu`` on the plain route on the CPU.
Outputs: tank_delta_u.png, the printed tracking metrics and the kernel's
launches. Imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from koopmanx_torch import configs as C  # noqa: E402
from koopmanx_torch.device import default_qp_backend  # noqa: E402
from koopmanx_torch.eval.metrics import steady_state_error, tracking_mse  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import build_pipeline, run_single  # noqa: E402


def config(steps: int = 1200, qp_backend: str = "pallas") -> C.RunConfig:
    """The tank preset, ``steps`` long, the box QP on ``qp_backend``."""
    cfg = C.tank_preset()
    cfg.steps = steps
    cfg.mpc.qp_backend = qp_backend
    return cfg


def loop_metrics(log) -> dict:
    """Tracking MSE and steady-state error of x2 against r and the applied
    input's range, of one scenario's log (T, ...)."""
    x2, u, r = log.x[:, 1].cpu(), log.u[:, 0].cpu(), log.r[:, 0].cpu()
    return dict(mse=float(tracking_mse(x2, r)),
                sse=float(steady_state_error(x2, r)),
                u_min=float(u.min()), u_max=float(u.max()))


def run(steps: int = 1200, device=None) -> dict:
    """The loop, one scenario from the preset's x_init, on ``device``
    (None: the card; the kernel route there, the plain one on the CPU).
    Returns the ``log``, the sample period ``h``, ``metrics``
    (:func:`loop_metrics`) and the box-ADMM ``launches``."""
    cfg = config(steps, default_qp_backend(device))
    before = box_admm.launches
    _, log = run_single(build_pipeline(cfg, device=device))
    return dict(log=log, h=cfg.data.h, metrics=loop_metrics(log),
                launches=box_admm.launches - before)


def figure(result: dict, out: str) -> None:
    """x2 against r over the applied input (matplotlib; raises where it is
    not installed)."""
    from koopmanx_torch.eval.plots import input_trace, tracking

    log, h = result["log"], result["h"]
    ax = tracking(log.x, log.r, h=h, channel=1)
    fig = ax.figure
    ax2 = fig.add_subplot(2, 1, 2)
    input_trace(log.u, h=h, bounds=(-8, 8), ax=ax2)
    fig.savefig(out, dpi=120, bbox_inches="tight")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--out", default="tank_delta_u.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    result = run(args.steps, device="cpu" if args.cpu else None)
    m = result["metrics"]
    print(f"tracking MSE (x2 vs r=1):  {m['mse']:.5f}")
    print(f"steady-state error:        {m['sse']:.5f}")
    print(f"applied input range:       [{m['u_min']:.3f}, {m['u_max']:.3f}] "
          "(bounds ±8)")
    print(f"box-ADMM kernel launches: {result['launches']}")
    figure(result, args.out)
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
