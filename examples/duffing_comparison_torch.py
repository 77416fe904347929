"""The reference's central experiment on the PyTorch port (the counterpart
of ``examples/duffing_comparison.py``): the same Duffing tracking scenario
run twice, static Koopman model vs online-updated model, with a live
plant-parameter switch mid-run, overlaid (duffing.py runs both loops and
plots the comparison at :1031-1051; the switch makes the static model's
tracking degrade while the online update adapts).

Run:  python examples/duffing_comparison_torch.py [--steps 600]
      [--switch 150] [--cpu]
On the card (the default) the box QP of every step runs in the box-ADMM
kernel, one launch a step; with ``--cpu`` on the plain route on the CPU.
Outputs: duffing_comparison.png, the printed MSEs and the kernel's
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

MODES = ("off", "rls_sqrt")
H = 0.05


def config(mode: str, steps: int = 600, switch: int = 150,
           qp_backend: str = "pallas") -> C.RunConfig:
    """The shipped duffing preset with update ``mode``, ``steps`` long, the
    plant switch live at ``switch``, the box QP on ``qp_backend``."""
    cfg = C.duffing_nn_preset()
    cfg.steps = steps
    cfg.switch_step = switch  # make the switch LIVE for the A/B
    cfg.update.mode = mode
    cfg.mpc.qp_backend = qp_backend
    return cfg


def loop_metrics(log, switch: int = 150) -> dict:
    """Tracking MSE of x1, its post-switch MSE (from ``switch + 50``, past
    the re-convergence window) and steady-state error of one scenario's
    log (T, ...)."""
    x1, r1 = log.x[:, 0].cpu(), log.r[:, 0].cpu()
    post = slice(switch + 50, None)
    return dict(mse=float(tracking_mse(x1, r1)),
                mse_post=float(tracking_mse(x1[post], r1[post])),
                sse=float(steady_state_error(x1, r1)))


def compare(steps: int = 600, switch: int = 150, device=None) -> dict:
    """Both loops from the preset's x_init on ``device`` (None: the card;
    the kernel route there, the plain one on the CPU). Returns ``logs``
    and ``metrics`` (:func:`loop_metrics`) by update mode and the
    box-ADMM ``launches`` of the two runs."""
    logs, metrics = {}, {}
    before = box_admm.launches
    for mode in MODES:
        cfg = config(mode, steps, switch, default_qp_backend(device))
        _, logs[mode] = run_single(build_pipeline(cfg, device=device))
        metrics[mode] = loop_metrics(logs[mode], switch)
    return dict(logs=logs, metrics=metrics,
                launches=box_admm.launches - before)


def figure(result: dict, out: str, switch: int) -> None:
    """The overlay of both runs (matplotlib; raises where it is not
    installed)."""
    from koopmanx_torch.eval.plots import tracking

    logs = result["logs"]
    ax = tracking(logs["rls_sqrt"].x, logs["rls_sqrt"].r, h=H,
                  x_compare=logs["off"].x,
                  labels=("online update", "static model"))
    ax.axvline(switch * H, color="k", linestyle=":", label="plant switch")
    ax.legend()
    ax.set_title("Duffing tracking: online-updated vs static Koopman model")
    ax.figure.savefig(out, dpi=130)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--switch", type=int, default=150)
    ap.add_argument("--out", default="duffing_comparison.png")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    result = compare(args.steps, args.switch,
                     device="cpu" if args.cpu else None)
    for mode in MODES:
        m = result["metrics"][mode]
        print(f"update={mode}: tracking MSE = {m['mse']:.5f}  "
              f"post-switch MSE = {m['mse_post']:.5f}")
    print(f"box-ADMM kernel launches: {result['launches']}")
    figure(result, args.out, args.switch)
    print(f"figure: {args.out}")
    return result


if __name__ == "__main__":
    main()
