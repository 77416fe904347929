"""Command-line interface of the port (counterpart of ``koopmanx/cli.py``):

  python -m koopmanx_torch.cli run --preset duffing --steps 300
  python -m koopmanx_torch.cli run --config my_config.json --save-log out.npz
  python -m koopmanx_torch.cli sweep --preset duffing --batch 8192
  python -m koopmanx_torch.cli train --system duffing --export out/duffing
  python -m koopmanx_torch.cli bench --batch 8192 --steps 200
  python -m koopmanx_torch.cli presets

Runs go to the CUDA card unless ``--cpu`` asks for the CPU; without a card
and without ``--cpu`` they raise. On the card the box QP takes the kernel
route (``mpc.qp_backend='pallas'``, the hand-written box-ADMM kernel) unless
``-o mpc.qp_backend=xla`` asks for the plain PyTorch route; with ``--cpu``
the plain route. The presets' own default is ``'xla'``, as in the JAX
package, so the CLI sets the route itself. ``--x64`` runs in float64.
``train`` fits a KMAE encoder and decoder on the same device rule.
``--figures`` (``run``, ``modes``) draws the figure set with matplotlib,
which must be installed. ``bench`` runs ``koopmanx_torch.bench`` (the
counterpart of ``bench.py``) on the same device rule, the kernel route on
the card and the plain route with ``--cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import configs as C

ROUTE_HELP = (
    "the box QP runs through the box-ADMM CUDA kernel on the card "
    "(mpc.qp_backend=pallas; -o mpc.qp_backend=xla for the plain PyTorch "
    "route), and the plain route with --cpu; the presets' own default, "
    "'xla', would send the card through the plain route")


def _apply_overrides(cfg, overrides):
    """``dotted.key=value`` items, each value typed as the field it
    replaces (bool, int, float, else the string)."""
    for item in overrides:
        key, _, val = item.partition("=")
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        cur = getattr(obj, parts[-1])
        if isinstance(cur, bool):
            val = val.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(val)
        elif isinstance(cur, float):
            val = float(val)
        setattr(obj, parts[-1], val)
    return cfg


def _device(args):
    """The run's device: the CPU under ``--cpu``, else the card (raising
    without one)."""
    from .device import resolve_device

    return resolve_device("cpu" if args.cpu else None)


def _config(args):
    """The preset (or ``--config`` file) with ``--steps``, the route of the
    run's device, ``--x64``, then the overrides."""
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = C.RunConfig.from_json(f.read())
    else:
        cfg = C.PRESETS[args.preset]()
    if args.steps:
        cfg.steps = args.steps
    cfg.mpc.qp_backend = "xla" if args.cpu else "pallas"
    if getattr(args, "x64", False):
        cfg.dtype = "float64"
    return _apply_overrides(cfg, args.override or [])


def cmd_run(args):
    import numpy as np
    import torch

    from .eval.metrics import steady_state_error, tracking_mse
    from .run import build_pipeline, run_single

    device = _device(args)
    cfg = _config(args)
    pipe = build_pipeline(cfg, device=device)
    carry, log = run_single(pipe)
    x, r = log.x.cpu(), log.r.cpu()
    if cfg.mpc.cy_index is not None:
        y, r_head = x[:, cfg.mpc.cy_index], r[:, 0]
    elif cfg.mpc.track_lifted:
        y = x[:, 0]
        r_head = torch.full_like(y, cfg.reference_value)
    else:
        y, r_head = x[:, 0], r[:, 0]
    if args.archive:
        from .eval.persist import archive_run

        archive_run(args.archive, log, h=cfg.data.h, mat=args.mat)
    if args.figures:
        from .eval.plots import save_figure_bundle

        bounds = (cfg.mpc.u_min, cfg.mpc.u_max)
        # C-map reconstruction of the closed-loop trajectory through the
        # initial model (duffing.py:354-390 reconstruction subplots)
        with torch.no_grad():
            x_recon = pipe.dictionary(log.x) @ pipe.model0.C.T
        save_figure_bundle(
            args.figures, log, h=cfg.data.h, u_bounds=bounds,
            data=pipe.data, recon=(x, x_recon),
            # spectrum + eigenfunction gallery of the final online-updated
            # operator (what the adaptation converged to)
            spectral=(carry.model, pipe.dictionary))
    summary = {
        "system": cfg.system,
        "steps": cfg.steps,
        "tracking_mse": float(tracking_mse(y, r_head)),
        "steady_state_error": float(
            steady_state_error(y, r_head, tail=min(50, cfg.steps))),
        "u_abs_max": float(log.u.abs().max()),
        "mean_drift_A": float(log.drift_a.mean()),
        "mean_residual": float(log.residual.mean()),
        "final_state": carry.x.cpu().tolist(),
    }
    print(json.dumps(summary, indent=2))
    if args.save_log:
        np.savez(args.save_log, **{
            k: getattr(log, k).cpu().numpy() for k in (
                "x", "u", "r", "drift_a", "drift_b", "drift_c", "residual")})
        print(f"log saved to {args.save_log}", file=sys.stderr)


def cmd_validate(args):
    import torch

    from .device import torch_dtype
    from .eval.openloop import openloop_validate
    from .run import build_pipeline
    from .systems.data import collect
    from .systems.library import get_system

    device = _device(args)
    cfg = C.PRESETS[args.preset]()
    if args.x64:
        cfg.dtype = "float64"
    pipe = build_pipeline(cfg, device=device)
    # a fresh validation rollout from the next seed (the reference
    # re-seeds and regenerates, duffing.py:264)
    data = collect(
        get_system(cfg.system), torch.Generator().manual_seed(cfg.seed + 1),
        n_step=max(args.steps, cfg.data.n_step), n_traj=1, h=cfg.data.h,
        u_range=cfg.data.u_range, x0_range=cfg.data.x0_range,
        integrator=cfg.integrator, clamp_x0=cfg.data.clamp_x0,
        dtype=torch_dtype(cfg.dtype))
    res = openloop_validate(pipe.model0, pipe.dictionary,
                            data.x[: args.steps].to(device),
                            data.u[: args.steps].to(device),
                            reencode_every=args.reencode_every)
    print(json.dumps({
        "system": cfg.system,
        "steps": int(args.steps),
        "rmse_reference_formula": float(res.rmse_ref),
        "rmse": float(res.rmse),
    }, indent=2))


def cmd_sweep(args):
    """A randomized scenario sweep: one batched loop over plants drawn
    around the preset's (BASELINE.json configuration 5)."""
    import torch

    from .device import torch_dtype
    from .engine.scenario import sample_scenarios
    from .run import build_pipeline, run_scenarios
    from .systems.library import get_system

    device = _device(args)
    cfg = _config(args)
    pipe = build_pipeline(cfg, device=device)
    batch = sample_scenarios(
        get_system(cfg.system), torch.Generator().manual_seed(args.seed),
        args.batch, param_scale=args.param_scale,
        dtype=torch_dtype(cfg.dtype), device=device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    _, logs = run_scenarios(pipe, batch)
    sync()
    wall = time.perf_counter() - t0
    x = logs.x.cpu()  # (B, T, n)
    track_err = (x[:, -min(50, cfg.steps):, 0]
                 - cfg.reference_value).abs().mean(dim=1)
    finite = torch.isfinite(x).all(dim=2).all(dim=1)
    err = track_err[finite].double()
    print(json.dumps({
        "system": cfg.system,
        "scenarios": args.batch,
        "steps": cfg.steps,
        "param_scale": args.param_scale,
        "wall_s": round(wall, 3),
        "solves_per_s": round(args.batch * cfg.steps / wall, 1),
        "finite_fraction": float(finite.double().mean()),
        "tracking_err_mean": float(err.mean()),
        "tracking_err_p95": float(torch.quantile(err, 0.95)),
        "tracking_err_max": float(err.max()),
    }, indent=2))


def cmd_modes(args):
    """The Koopman spectrum of a preset's identified operator (the
    reference's duffing.py:627 / :659-665 sanity numbers)."""
    from .eval.modes import spectrum_summary
    from .run import build_pipeline, run_single

    device = _device(args)
    cfg = _config(args)
    pipe = build_pipeline(cfg, device=device)
    model, label = pipe.model0, "batch-EDMD model"
    if args.final:
        carry, _ = run_single(pipe)
        model = carry.model
        label = f"online model after {cfg.steps} steps"
    summary = spectrum_summary(model, h=cfg.data.h)
    summary["model"] = label
    print(json.dumps(summary, indent=2))
    if args.figures:
        from .eval.modes import spectral_decomposition
        from .eval.plots import eigenfunction_gallery, spectrum_plot

        fig = eigenfunction_gallery(model, pipe.dictionary, h=cfg.data.h,
                                    top=args.top)
        fig.savefig(f"{args.figures}_eigenfunctions.png", dpi=130)
        ax = spectrum_plot(spectral_decomposition(model, h=cfg.data.h))
        ax.figure.savefig(f"{args.figures}_spectrum.png", dpi=130)
        print(f"wrote {args.figures}_eigenfunctions.png, "
              f"{args.figures}_spectrum.png")


def cmd_presets(args):
    for name, factory in C.PRESETS.items():
        cfg = factory()
        print(f"{name}: {cfg.system}, steps={cfg.steps}, "
              f"horizon={cfg.mpc.horizon}")
        if args.verbose:
            print(cfg.to_json())


def cmd_bench(args):
    """``koopmanx_torch.bench`` with ``--batch``, ``--steps`` and
    ``--horizon`` as ``BENCH_BATCH``, ``BENCH_STEPS`` and
    ``BENCH_HORIZON`` (``koopmanx/cli.py:125-138``), and ``--cpu`` as
    ``BENCH_DEVICE=cpu``; the other ``BENCH_*`` knobs from the
    environment."""
    import os

    from . import bench

    env = dict(os.environ)
    for k, v in (("BENCH_BATCH", args.batch), ("BENCH_STEPS", args.steps),
                 ("BENCH_HORIZON", args.horizon)):
        if v:
            env[k] = str(v)
    if args.cpu:
        env["BENCH_DEVICE"] = "cpu"
    bench.main(env)


def cmd_train(args):
    """Collect the system's random-excitation data, fit a KMAE encoder
    and decoder (``--checkpoint`` is written and, where it exists, resumed
    from), export the ``.mat`` weights and print the last epoch's record."""
    import torch

    from .systems.data import collect
    from .systems.library import get_system
    from .train.kmae import KMAEConfig
    from .train.trainer import export_weights, fit

    device = _device(args)
    data = collect(get_system(args.system),
                   torch.Generator().manual_seed(args.seed),
                   n_step=args.n_step, n_traj=args.n_traj)
    cfg = KMAEConfig(pred_horizon=args.pred_horizon, epochs=args.epochs)
    state, history = fit(data, n_step=args.n_step, cfg=cfg, nlift=args.nlift,
                         hidden=args.hidden, seed=args.seed,
                         checkpoint_path=args.checkpoint,
                         resume=bool(args.checkpoint), device=device)
    if args.export:
        export_weights(state, args.export)
        print(f"weights exported to {args.export}_encoder.mat / "
              "_decoder.mat", file=sys.stderr)
    print(json.dumps({"final": history[-1] if history else None}, indent=2))


def _device_flags(p, x64: bool = True):
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card, which must "
                        "be present); " + ROUTE_HELP)
    if x64:
        p.add_argument("--x64", action="store_true", help="run in float64")


def main(argv=None):
    p = argparse.ArgumentParser(prog="koopmanx_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    presets = list(C.PRESETS)

    pr = sub.add_parser("run", help="run a closed-loop scenario")
    pr.add_argument("--preset", default="duffing", choices=presets)
    pr.add_argument("--config", help="JSON RunConfig file")
    pr.add_argument("--steps", type=int)
    pr.add_argument("--override", "-o", action="append", help="dotted.key=value")
    pr.add_argument("--save-log")
    pr.add_argument("--archive", help="write a results bundle (.npz)")
    pr.add_argument("--mat", action="store_true",
                    help="also write the reference-schema .mat bundle")
    pr.add_argument("--figures",
                    help="prefix for the standard figure set (PNG; needs "
                         "matplotlib)")
    _device_flags(pr)
    pr.set_defaults(fn=cmd_run)

    pv = sub.add_parser("validate",
                        help="open-loop multi-step prediction validation")
    pv.add_argument("--preset", default="duffing", choices=presets)
    pv.add_argument("--steps", type=int, default=500)
    pv.add_argument("--reencode-every", type=int, default=0)
    _device_flags(pv)
    pv.set_defaults(fn=cmd_validate)

    pt = sub.add_parser("train", help="train a KMAE encoder/decoder")
    pt.add_argument("--system", default="duffing")
    pt.add_argument("--nlift", type=int, default=8)
    pt.add_argument("--hidden", type=int, default=100)
    pt.add_argument("--epochs", type=int, default=20)
    pt.add_argument("--pred-horizon", type=int, default=6)
    pt.add_argument("--n-step", type=int, default=100)
    pt.add_argument("--n-traj", type=int, default=100)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--checkpoint",
                    help="npz checkpoint path (resume if exists)")
    pt.add_argument("--export", help="prefix for .mat weight export")
    pt.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card, which "
                         "must be present)")
    pt.set_defaults(fn=cmd_train)

    pb = sub.add_parser(
        "bench", help="the headline benchmark: batched closed-loop solves/s "
                      "(koopmanx_torch.bench; BENCH_* knobs from the "
                      "environment)")
    pb.add_argument("--batch", type=int)
    pb.add_argument("--steps", type=int)
    pb.add_argument("--horizon", type=int)
    pb.add_argument("--cpu", action="store_true",
                    help="run on the CPU, the plain route (BENCH_DEVICE=cpu; "
                         "default: the CUDA card, which must be present, "
                         "and the box-ADMM kernel)")
    pb.set_defaults(fn=cmd_bench)

    ps = sub.add_parser("sweep",
                        help="randomized scenario sweep (batched plants)")
    ps.add_argument("--preset", default="duffing", choices=presets)
    ps.add_argument("--batch", type=int, default=1024)
    ps.add_argument("--steps", type=int, default=200)
    ps.add_argument("--param-scale", type=float, default=0.2)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--override", "-o", action="append")
    _device_flags(ps)
    ps.set_defaults(fn=cmd_sweep)

    pm = sub.add_parser(
        "modes", help="Koopman spectrum analysis of a preset's operator")
    pm.add_argument("--preset", default="duffing", choices=presets)
    pm.add_argument("--steps", type=int, default=None)
    pm.add_argument("--final", action="store_true",
                    help="analyze the online-updated model after a run "
                         "(default: the batch-EDMD model)")
    pm.add_argument("--figures", default=None,
                    help="prefix for the spectrum and eigenfunction figures "
                         "(PNG; needs matplotlib)")
    pm.add_argument("--top", type=int, default=8)
    pm.add_argument("-o", "--override", action="append")
    _device_flags(pm)
    pm.set_defaults(fn=cmd_modes)

    pp = sub.add_parser("presets", help="list the reference-scenario presets")
    pp.add_argument("--verbose", "-v", action="store_true")
    pp.set_defaults(fn=cmd_presets)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
