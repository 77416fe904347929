#!/usr/bin/env python
"""Multi-process scaling of the PyTorch port's sharded closed loop
(counterpart of ``tools/bench_multihost.py``).

Runs the production workload, the scenario-parallel closed loop
(``parallel.sharded_closed_loop``; on the card each step launches the
box-ADMM kernel once), in three settings of weak scaling (the global batch
grows with the ranks):

  - one process (P = 1);
  - P = ``--procs`` ranks of one ``torch.distributed`` job brought up by
    ``parallel.initialize_multihost`` on a localhost TCP store;
  - the co-run baseline: P independent single-process workers whose reps
    a file barrier aligns, so that the throughput is the minimum over reps
    of each rep's global wall (the slowest worker's), never a mix of
    per-worker minima from different reps;

and reports the closed-loop solves/s of each, the weak-scaling efficiency
T(P) / (P T(1)) (``weak_scaling_efficiency``), its split into hardware
contention (co-run against P = 1) and the process boundary (the job
against the co-run), and the all-reduce time of one EDMD Gram of shape
(nlift + 1)^2 over the ranks (50 reps, one synchronization after them),
the one collective the pipeline issues per fit.

Backends: NCCL where every rank has a card of its own; gloo where ranks
share a card (NCCL refuses two ranks on one device) or run on the CPU.
With ``--cpu`` each rank is pinned to a core of its own with ``taskset``
(``--no-pin`` turns that off); ranks on cards are not pinned. The JAX
tool's ``--dev-per-proc`` has no counterpart: a rank holds one device.

Each rank's output goes to a log in a temporary directory, which is
removed when every rank succeeds; a rank that fails or outlives its
timeout fails the run with the tail of its log. Prints one JSON object
(indented, as the JAX tool does) with the JAX tool's keys, plus each
setting's backend and box-ADMM launches and the card's name and power
limit. It runs on the card unless ``--cpu`` is given and raises without
one. It imports no JAX.

  python tools/bench_multihost_torch.py [--batch 64] [--steps 40]
      [--procs 2] [--repeat 1] [--cpu] [--no-pin] [--rank-timeout 900]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
RANK_TIMEOUT = 900  # seconds a rank may take
GRAM_REPS = 50


def _trace(rank: int, msg: str) -> None:
    print(f"[rank {rank}] {msg}", file=sys.stderr, flush=True)


def _file_barrier(directory: str, name: str, rank: int, world: int) -> None:
    open(os.path.join(directory, f"{name}.{rank}"), "w").close()
    deadline = time.perf_counter() + 600.0
    while sum(os.path.exists(os.path.join(directory, f"{name}.{r}"))
              for r in range(world)) < world:
        if time.perf_counter() > deadline:
            raise RuntimeError(f"file barrier {name} timed out")
        time.sleep(0.002)


def worker() -> int:
    """One rank, configured by the ``KX_*`` environment that
    :func:`run_config` sets."""
    import torch
    import torch.distributed as dist

    from koopmanx_torch import configs as C
    from koopmanx_torch.device import default_qp_backend, resolve_device
    from koopmanx_torch.engine.scenario import sample_scenarios
    from koopmanx_torch.ops.box_admm import box_admm
    from koopmanx_torch.parallel import (
        initialize_multihost,
        make_mesh,
        sharded_closed_loop,
    )
    from koopmanx_torch.parallel.mesh import local_device
    from koopmanx_torch.parallel.sharded import psum
    from koopmanx_torch.run import build_pipeline, replicate
    from koopmanx_torch.systems.library import get_system

    env = os.environ
    nproc, rank = int(env["KX_NPROC"]), int(env["KX_RANK"])
    steps, b_local = int(env["KX_STEPS"]), int(env["KX_LOCAL_BATCH"])
    kind = "cpu" if env.get("KX_CPU") == "1" else "cuda"
    barrier_dir = env.get("KX_BARRIER_DIR", "")
    corun_world = int(env.get("KX_WORLD", "1"))
    corun_rank = int(env.get("KX_CORUN_RANK", "0"))
    if kind == "cpu":
        torch.set_num_threads(1)
    resolve_device(kind)  # raises without a card, TF32 off
    initialize_multihost(env["KX_COORD"], nproc, rank,
                         backend=env.get("KX_BACKEND") or None)
    mesh = make_mesh(kind)
    device = local_device(mesh)
    group = mesh.get_group("data")

    def barrier(name):
        _trace(rank, f"-> barrier {name}")
        if nproc > 1:
            dist.barrier(group)
        elif barrier_dir and corun_world > 1:
            _file_barrier(barrier_dir, name, corun_rank, corun_world)
        _trace(rank, f"<- barrier {name}")

    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    cfg = C.duffing_nn_preset()
    cfg.steps = steps
    cfg.dtype = "float32"
    cfg.data = C.DataConfig(n_step=16, n_traj=16)
    cfg.mpc.qp_backend = default_qp_backend(device)
    pipe = build_pipeline(cfg, device=device)  # the same on every rank
    sc = sample_scenarios(get_system("duffing"),
                          torch.Generator().manual_seed(rank), b_local,
                          param_scale=0.15, device=device)
    args = (replicate(pipe.params, b_local), sc.x0,
            replicate(pipe.model0, b_local), replicate(pipe.rls0, b_local),
            sc.theta0, sc.theta1)
    barrier("built")

    def run():
        _, logs = sharded_closed_loop(pipe.closed_loop, mesh, *args)
        sync()
        return logs

    _trace(rank, "warm run")
    run()
    reps = int(env.get("KX_REPS", "5"))
    rep_walls, before = [], box_admm.launches
    for r_i in range(reps):
        barrier(f"bench_start_{r_i}")
        t0 = time.perf_counter()
        logs = run()
        barrier(f"bench_end_{r_i}")  # global completion
        rep_walls.append(time.perf_counter() - t0)
    launches = box_admm.launches - before
    wall = min(rep_walls)
    b_global = b_local * nproc

    # the cross-process collective: the EDMD Gram's all-reduce
    d = pipe.dictionary.nlift + 1  # lifted dim + m
    gram = torch.ones((b_local, d, d), dtype=torch.float32, device=device)
    psum(gram.sum(0), group)  # warm
    sync()
    barrier("psum_start")
    t0 = time.perf_counter()
    for _ in range(GRAM_REPS):
        out = psum(gram.sum(0), group)
    sync()
    psum_us = (time.perf_counter() - t0) / GRAM_REPS * 1e6
    del out

    # finiteness of the whole batch: every rank's flag, reduced by MIN
    flag = torch.isfinite(logs.x).all().to(torch.int32).reshape(1)
    dist.all_reduce(flag, dist.ReduceOp.MIN, group=group)
    finite = bool(flag.item())
    if rank == 0:
        print(json.dumps({
            "procs": nproc,
            "devices_global": (nproc if kind == "cpu" else
                               min(nproc, torch.cuda.device_count())),
            "batch_global": b_global,
            "steps": steps,
            "wall_s": round(wall, 4),
            "rep_walls": [round(w, 4) for w in rep_walls],
            "solves_per_s": round(b_global * steps / wall, 1),
            "gram_psum_us": round(psum_us, 1),
            "finite": finite,
            "backend": dist.get_backend(group),
            "box_admm_launches": launches,
        }), flush=True)
    barrier("done")
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(nproc: int, cpu: bool) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if cpu:
        return "gloo"
    import torch

    return "nccl" if torch.cuda.device_count() >= nproc else "gloo"


def run_config(nproc: int, local_batch: int, steps: int, cpu: bool = False,
               pin_cores: bool = False, distributed: bool = True,
               timeout: float = RANK_TIMEOUT, env=None):
    """One setting: ``nproc`` ranks of one job (``distributed``), or
    ``nproc`` independent single-process workers aligned by a file
    barrier (the contention baseline). Returns the setting's record."""
    port = _free_port()
    base = dict(os.environ if env is None else env)
    base.update({
        "KX_COORD": f"127.0.0.1:{port}",
        "KX_NPROC": str(nproc if distributed else 1),
        "KX_STEPS": str(steps),
        "KX_LOCAL_BATCH": str(local_batch),
        "KX_CPU": "1" if cpu else "0",
        "KX_BACKEND": backend_for(nproc if distributed else 1, cpu),
    })
    tmp = tempfile.mkdtemp(prefix="kx_multihost_")
    if not distributed and nproc > 1:
        base["KX_BARRIER_DIR"] = tmp
        base["KX_WORLD"] = str(nproc)
    tag = f"p{nproc}" if distributed else f"corun{nproc}"
    procs, logs = [], []
    try:
        for rank in range(nproc):
            path = os.path.join(tmp, f"multihost_{tag}_r{rank}.log")
            logs.append(path)
            cmd = [sys.executable, "-u", os.path.abspath(__file__),
                   "--worker"]
            if pin_cores:
                cmd = ["taskset", "-c", str(rank)] + cmd
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    cmd, env={**base, "KX_RANK": str(rank if distributed
                                                     else 0),
                              "KX_CORUN_RANK": str(rank)},
                    stdout=f, stderr=subprocess.STDOUT))
        failed, deadline = [], time.monotonic() + timeout
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed.append((rank, f"timeout after {timeout} s"))
                continue
            if p.returncode != 0:
                failed.append((rank, f"rc={p.returncode}"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        msgs = []
        for rank, why in failed:
            with open(logs[rank]) as f:
                msgs.append(f"--- rank {rank} ({why}) tail of {logs[rank]}:"
                            f"\n{f.read()[-2000:]}")
        raise RuntimeError("worker(s) failed:\n" + "\n".join(msgs))
    results = []
    for path in logs:
        r = None
        with open(path) as f:
            for line in f:
                if line.startswith("{"):
                    r = json.loads(line)
        results.append(r)
    shutil.rmtree(tmp, ignore_errors=True)
    if distributed or nproc == 1:
        return results[0]
    total = sum(r["batch_global"] * r["steps"] for r in results)
    n_reps = min(len(r["rep_walls"]) for r in results)
    global_walls = [max(r["rep_walls"][i] for r in results)
                    for i in range(n_reps)]
    wall = min(global_walls)
    return {
        "procs": nproc,
        "independent": True,
        "batch_global": sum(r["batch_global"] for r in results),
        "steps": results[0]["steps"],
        "wall_s": round(wall, 4),
        "rep_walls_global": [round(w, 4) for w in global_walls],
        "solves_per_s": round(total / wall, 1),
        "finite": all(r["finite"] for r in results),
        "backend": results[0]["backend"],
        "box_admm_launches": sum(r["box_admm_launches"] for r in results),
    }


EFFICIENCIES = ("weak_scaling_efficiency", "hardware_contention_efficiency",
                "process_boundary_efficiency")


def main(argv=None) -> dict:
    """All three settings, ``--repeat`` times; print and return the
    record."""
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64,
                    help="per-process scenarios")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--no-pin", action="store_true",
                    help="with --cpu, do not pin each rank to a core")
    ap.add_argument("--repeat", type=int, default=1,
                    help="repeat the (single, corun, multi) measurement N "
                         "times and report the median and IQR of each "
                         "efficiency")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rank-timeout", type=float, default=RANK_TIMEOUT,
                    help="seconds each setting's ranks may take")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker()

    card = None
    if not args.cpu:
        from koopmanx_torch.device import card_line, resolve_device
        from koopmanx_torch.ops import build

        resolve_device(None)  # raises without a card
        build.build_all(["box_admm"])  # once, before the ranks load it
        card = card_line()
    pin = args.cpu and not args.no_pin and os.cpu_count() >= args.procs
    kw = dict(cpu=args.cpu, pin_cores=pin, timeout=args.rank_timeout)
    runs = []
    for rep in range(args.repeat):
        single = run_config(1, args.batch, args.steps, **kw)
        corun = run_config(args.procs, args.batch, args.steps,
                           distributed=False, **kw)
        multi = run_config(args.procs, args.batch, args.steps, **kw)
        runs.append({
            "single_process": single,
            "independent_corun": corun,
            "multi_process": multi,
            "weak_scaling_efficiency": round(
                multi["solves_per_s"]
                / (args.procs * single["solves_per_s"]), 3),
            "hardware_contention_efficiency": round(
                corun["solves_per_s"]
                / (args.procs * single["solves_per_s"]), 3),
            "process_boundary_efficiency": round(
                multi["solves_per_s"] / corun["solves_per_s"], 3),
        })
        if args.repeat > 1:
            print(json.dumps({"rep": rep, **{k: runs[-1][k]
                                             for k in EFFICIENCIES}}),
                  flush=True)

    def med_iqr(key):
        v = np.asarray([r[key] for r in runs])
        q25, q50, q75 = np.percentile(v, [25, 50, 75])
        return {"median": round(float(q50), 3),
                "iqr": [round(float(q25), 3), round(float(q75), 3)],
                "min": round(float(v.min()), 3),
                "max": round(float(v.max()), 3), "n": len(runs)}

    out = dict(runs[-1])
    if args.repeat > 1:
        out["summary"] = {k: med_iqr(k) for k in EFFICIENCIES}
    out["cores_pinned_per_rank"] = pin
    out["caveat"] = (
        "one host: ranks sharing a card or the CPU's cores contend for "
        "them, which pushes the efficiency down, and the all-reduce runs "
        "over localhost (gloo's TCP, or NCCL between cards of one host); "
        "these numbers bound the cost of the process boundary, they are "
        "not a multi-host measurement")
    out["card"] = card
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
