"""Run one cell of the benchmark once, and print its result as the last
line of standard output:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the start of this module): the port's
import and the CUDA context, ``run.build_pipeline`` (the snapshots, the
lift, the EDMD fit, the estimator), the kernel's load (built once into the
checkout's ``koopmanx_torch/_build``), the first episode's scenarios and a
warm-up of the cell's own shapes. Then a window of ``--seconds``:

- ``sweep``: episodes of the configuration's length run back to back
  through ``with_engine_config(pipe, steps=chunk).closed_loop`` in chunks,
  each later episode's scenarios drawn on the device from the seed;
- ``serve``: ``BatchedController.step`` on the whole fleet, one call at a
  time, u read back on the host; the caller then steps its plants (the
  reference's plant step, on the device), switches their parameters after the
  configuration's switch step and resets the fleet each episode.

After the window: the check that no JAX was loaded, then the comparison
with the plain reference (:mod:`benchmark.check`) on a sample of
scenarios drawn from the seed. With ``--trace 1`` a stretch of the window
runs under ``torch.profiler`` with the benchmark's ranges around the
program's layers, and the line carries the per-layer metrics.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from . import check, spec, traffic as traffic_gen  # noqa: E402
from .reference import F64, Reference, plant_function  # noqa: E402
from .trace import Stretches, install_ranges, range_dictionary  # noqa: E402

THREADS = 4  # the host threads of the program's set-up on the CPU


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _host(tree, idx: torch.Tensor):
    """The sampled rows of every tensor leaf of a NamedTuple, tuple or
    dict, on the host; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host(v, idx) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [_host(v, idx) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree[idx.to(tree.device)].cpu()


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_config(config: dict):
    """The configuration as the program runs it: its preset with the
    changed keys, which must equal the file's ``run_config``; the plant
    and the engine's constants must be the file's too."""
    import dataclasses
    import inspect

    from koopmanx_torch import configs as C
    from koopmanx_torch.control.terminal import synthesize_terminal
    from koopmanx_torch.run import engine_config
    from koopmanx_torch.systems.library import get_system

    cfg = C.PRESETS[config["preset"]]()
    for key, value in config["changed"].items():
        *path, last = key.split(".")
        obj = cfg
        for p in path:
            obj = getattr(obj, p)
        setattr(obj, last, value)
    as_json = json.loads(json.dumps(dataclasses.asdict(cfg)))
    if as_json != config["run_config"]:
        raise ValueError(f"{config['name']}: the preset with its changes is "
                         "not the file's run_config")
    plant, system = config["plant"], get_system(cfg.system)
    if ((system.n, system.m) != (plant["n"], plant["m"])
            or system.theta0._asdict() != plant["theta0"]
            or system.theta1._asdict() != plant["theta1"]):
        raise ValueError(f"{config['name']}: the plant is not the file's")
    ecfg, eng = engine_config(cfg), config["engine"]
    dare = inspect.signature(synthesize_terminal).parameters["iters"].default
    have = {k: getattr(ecfg, k) for k in eng if k != "dare_iters"}
    have["dare_iters"] = dare
    if have != eng:
        raise ValueError(f"{config['name']}: engine constants {have} are not "
                         f"the file's {eng}")
    return cfg


class Cell:
    """One cell, set up: the program built and warmed on ``device``."""

    def __init__(self, root: str, name: str, seed: int, device: str = "cuda",
                 trace: bool = False, overrides: Optional[dict] = None):
        torch.set_num_threads(THREADS)
        bench = spec.load_benchmark(root)
        self.root, self.name, self.device = root, name, torch.device(device)
        self.bench, self.entry = bench, spec.workload(bench, name)
        self.config = spec.part(root, "configs", self.entry["config"])
        self.traffic = dict(spec.part(root, "traffic", self.entry["traffic"]),
                            **(overrides or {}))
        self.limits = spec.part(root, "limits", name)["limits"]
        self.trace = trace
        from koopmanx_torch.run import build_pipeline

        self.cfg = run_config(self.config)
        if trace:
            install_ranges()
        t0 = time.perf_counter()
        self.import_s = t0 - _T0
        self.pipe = build_pipeline(self.cfg, device=self.device)
        _sync(self.device)
        self.pipeline_build_s = time.perf_counter() - t0
        if trace:
            range_dictionary(self.pipe.dictionary)
        self.dtype = self.pipe.x_init.dtype
        self.batch = self.traffic["scenarios"]
        self.episode = self.cfg.steps
        t1 = time.perf_counter()
        self.scenarios = self.draw(seed, 0)
        self.seed = seed
        getattr(self, f"_setup_{self.traffic['entry']}")()
        _sync(self.device)
        self.warmup_s = time.perf_counter() - t1
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.setup_s = time.perf_counter() - _T0

    # -- scenarios --------------------------------------------------------

    def draw(self, seed: int, episode: int):
        from koopmanx_torch.systems.library import get_system

        x0, th0, th1 = traffic_gen.draw(self.config["plant"], self.traffic,
                                        self.batch, seed, episode, self.dtype,
                                        self.device)
        kind = type(get_system(self.cfg.system).theta0)
        return x0, kind(**th0), kind(**th1)

    # -- sweep ------------------------------------------------------------

    def _setup_sweep(self) -> None:
        from koopmanx_torch.run import replicate, with_engine_config

        chunk = self.traffic["chunk_steps"]
        if self.episode % chunk:
            raise ValueError(f"an episode of {self.episode} steps is not "
                             f"whole chunks of {chunk}")
        pipe, b = self.pipe, self.batch
        self.loop = with_engine_config(pipe, steps=chunk).closed_loop
        self.args = (replicate(pipe.params, b), replicate(pipe.model0, b),
                     replicate(pipe.rls0, b))
        carry = None
        for k in range(self.traffic["warmup_chunks"]):
            carry = self._chunk(self.scenarios, carry, k * chunk)[0]
        self.draw(self.seed, 1)  # the device generator's first use

    def _chunk(self, sc, carry, offset: int):
        params, model0, rls0 = self.args
        x0, th0, th1 = sc
        return self.loop(params, x0, model0, rls0, th0, th1, carry0=carry,
                         step_offset=offset)

    def _window_sweep(self, seed: int, seconds: float) -> dict:
        tr = self.traffic
        chunk = tr["chunk_steps"]
        sc = self.scenarios if seed == self.seed else self.draw(seed, 0)
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        episode, offset, carry, chunks = 0, 0, None, 0
        start = last = None
        tracer = (Stretches(tr["trace_after_chunks"], tr["trace_chunks"],
                            self.device) if self.trace else None)
        t0 = time.perf_counter()
        if tracer:
            tracer.tick(0)
        while True:
            carry_in = carry
            carry, log = self._chunk(sc, carry_in, offset)
            bad += (~torch.isfinite(log.x)).any(-1).sum()
            kept = dict(offset=offset, carry_in=carry_in, carry=carry,
                        log=log, sc=sc)
            if offset == 0:
                start = kept
            else:  # the last stretch starts from the program's own state
                last = kept
            chunks += 1
            offset += chunk
            if tracer:
                tracer.tick(chunks)
            if offset == self.episode:
                episode, offset, carry = episode + 1, 0, None
                sc = self.draw(seed, episode)
            if (chunks >= tr["min_chunks"] and (not tracer or tracer.finished)
                    and time.perf_counter() - t0 >= seconds):
                break
        _sync(self.device)
        window_s = time.perf_counter() - t0
        rec = dict(solves=chunks * chunk * self.batch, window_s=window_s,
                   attempted=chunks * chunk * self.batch, failed=int(bad))
        if tracer:
            rec.update(profile=tracer, steps=tr["trace_chunks"] * chunk)
        self.kept = dict(start=start, last=last)
        return rec

    def _sweep_selection(self, idx: torch.Tensor) -> Dict:
        sel = {}
        for name, kept in self.kept.items():
            log, carry, carry_in = kept["log"], kept["carry"], kept["carry_in"]
            _, th0, th1 = kept["sc"]
            s = dict(x=_host(log.x, idx), u=_host(log.u, idx),
                     x_end=_host(carry.x, idx),
                     residual=_host(log.residual, idx),
                     est_end=_host(carry.rls, idx)._asdict(),
                     model_end=_host(carry.model, idx),
                     th0=_host(th0, idx)._asdict(),
                     th1=_host(th1, idx)._asdict(),
                     step0=kept["offset"])
            if self.cfg.mpc.terminal_synthesis:
                s.update(gamma=_host(log.gamma, idx),
                         ellipse=_host(log.ellipse, idx),
                         cert_end=_host(carry.cert, idx))
            if carry_in is not None:
                s.update(est_in=_host(carry_in.rls, idx)._asdict(),
                         model_in=_host(carry_in.model, idx),
                         warm_in=_host(carry_in.warm_x, idx),
                         cert_in=_host(carry_in.cert, idx))
            sel[name] = s
        return sel

    # -- serve ------------------------------------------------------------

    def _setup_serve(self) -> None:
        from koopmanx_torch.engine.controller import BatchedController

        self.ctrl = BatchedController.from_pipeline(self.pipe, self.batch)
        self.plant = plant_function(self.config, self.root)
        x0, th0, th1 = self.scenarios
        x = x0
        for k in range(self.traffic["warmup_calls"]):
            u = self.ctrl.step(x)
            u.cpu()
            x = self._plant(x, u, th0, th1, k)
        self.ctrl.reset(full=True)
        self.draw(self.seed, 1)

    def _plant(self, x, u, th0, th1, k: int):
        th = th1 if k > self.cfg.switch_step else th0
        return self.plant(x, u, th._asdict())

    def _window_serve(self, seed: int, seconds: float) -> dict:
        tr = self.traffic
        every = tr["check_calls"]
        if self.episode % every:
            raise ValueError(f"an episode of {self.episode} calls is not "
                             f"whole stretches of {every}")
        sc = self.scenarios if seed == self.seed else self.draw(seed, 0)
        ctrl = self.ctrl
        ctrl.reset(full=True)
        x, th0, th1 = sc
        k = episode = calls = failed = 0
        lat, dispatch = [], []
        stretch = start = last = None
        tracer = (Stretches(tr["trace_after_calls"], tr["trace_calls"],
                            self.device) if self.trace else None)
        t_w = time.perf_counter()
        if tracer:
            tracer.tick(0)
        while True:
            if k % every == 0:  # a checkpoint: close the stretch, open one
                if stretch is not None:
                    stretch["state_end"] = ctrl.state
                    if start is None:
                        start = stretch
                    else:
                        last = stretch
                if k == self.episode:
                    ctrl.reset()
                    episode, k = episode + 1, 0
                    x, th0, th1 = self.draw(seed, episode)
                stretch = dict(state_in=None if start is None else ctrl.state,
                               xs=[], us=[])
            t0 = time.perf_counter()
            u = ctrl.step(x)
            t1 = time.perf_counter()
            u_host = u.cpu()
            t2 = time.perf_counter()
            if not tracer or tracer.prof is None:
                dispatch.append(t1 - t0)
            lat.append(t2 - t0)
            failed += int(not torch.isfinite(u_host).all())
            if not stretch["xs"]:
                stretch["state_first"] = ctrl.state
            stretch["xs"].append(x)
            stretch["us"].append(u_host)
            x = self._plant(x, u, th0, th1, k)
            k += 1
            calls += 1
            if tracer:
                tracer.tick(calls)
            if (calls >= tr["min_calls"] and last is not None
                    and (not tracer or tracer.finished)
                    and time.perf_counter() - t_w >= seconds):
                break
        _sync(self.device)
        rec = dict(latencies_ms=[t * 1e3 for t in lat],
                   window_s=time.perf_counter() - t_w,
                   attempted=calls, failed=failed,
                   dispatch_ms=[t * 1e3 for t in dispatch])
        if tracer:
            rec.update(profile=tracer, steps=tr["trace_calls"])
        self.kept = dict(start=start, last=last)
        return rec

    def _serve_selection(self, idx: torch.Tensor) -> Dict:
        sel = {}
        for name, kept in self.kept.items():
            end = kept["state_end"]
            s = dict(x=torch.stack([_host(x, idx) for x in kept["xs"]], 1),
                     u=torch.stack([u[idx] for u in kept["us"]], 1),
                     est_end=_host(end.rls, idx)._asdict(),
                     model_end=_host(end.model, idx),
                     z_prev_end=_host(end.z_prev, idx))
            state = kept["state_in"]
            if state is not None:
                s.update(est_in=_host(state.rls, idx)._asdict(),
                         model_in=_host(state.model, idx),
                         warm_in=_host(state.warm_x, idx),
                         have_in=_host(state.have_prev, idx),
                         model_first=_host(kept["state_first"].model, idx),
                         z_prev_in=_host(state.z_prev, idx),
                         x_prev_in=_host(state.x_prev, idx),
                         u_prev_in=_host(state.u_prev, idx))
            sel[name] = s
        return sel

    # -- the run ----------------------------------------------------------

    def window(self, seed: int, seconds: float) -> dict:
        rec = getattr(self, f"_window_{self.traffic['entry']}")(seed, seconds)
        if "profile" in rec:
            rec["profile"] = rec["profile"].read()
        if self.device.type == "cuda":
            rec["window_peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
            rec["memory_peak_bytes"] = max(self.setup_peak,
                                           rec["window_peak_bytes"])
        return rec

    def selection(self, seed: int) -> Dict:
        """The sampled scenarios' part of what the window kept, on the host,
        with the set-up's fit and estimator."""
        gen = torch.Generator().manual_seed(traffic_gen.episode_seed(seed, -1))
        sample = min(self.traffic["check_scenarios"], self.batch)
        idx = torch.randperm(self.batch, generator=gen)[:sample]
        entry = self.traffic["entry"]
        sel = getattr(self, f"_{entry}_selection")(idx)
        sel["model0"] = tuple(t.cpu() for t in self.pipe.model0)
        sel["est0"] = {k: v.cpu() for k, v in self.pipe.rls0._asdict().items()}
        return sel

    def numbers(self, sel: Dict, prec=F64) -> Dict[str, float]:
        ref = Reference(self.config, self.root, prec)
        cast = lambda tree: _cast(tree, prec.dtype)
        return getattr(check, f"{self.traffic['entry']}_numbers")(ref, cast(sel))

    def free(self) -> None:
        """Drop the program's device state (what the check needs is on the
        host by now)."""
        for attr in ("kept", "loop", "args", "ctrl"):
            if hasattr(self, attr):
                delattr(self, attr)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_cast(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def result(cell: Cell, rec: dict, numbers: Dict[str, float], trace: bool
           ) -> dict:
    """The result's line: the cell's end-to-end metrics, or with ``trace``
    its per-layer ones, read from the run's record."""
    tr, cfg = cell.traffic, cell.cfg
    rec = dict(rec, entry=tr["entry"], setup_s=cell.setup_s,
               pipeline_build_s=cell.pipeline_build_s, batch=cell.batch,
               nx=cfg.mpc.horizon * cell.config["plant"]["m"],
               m=cell.config["plant"]["m"], nlift=cell.pipe.dictionary.nlift,
               qp_iters=cfg.mpc.qp_iters,
               dare_iters=cell.config["engine"]["dare_iters"],
               itemsize=torch.finfo(cell.dtype).bits // 8)
    which = spec.per_layer if trace else spec.end_to_end
    metrics = spec.read_metrics(cell.root, which(cell.bench, cell.name), rec)
    device = {"platform": "gpu",
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else "cpu"),
              "count": cell.entry["chips"],
              "memory_peak_bytes": rec.get("memory_peak_bytes", 0)}
    out = {"correct": check.judge(numbers, cell.limits),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    if trace:
        prof = rec["profile"]
        device["busy_s"] = prof["busy_us"] * 1e-6
        device["window_s"] = prof["window_us"] * 1e-6
        out["breakdown"] = prof["breakdown"]
    if cell.device.type == "cuda":
        device["card"] = card_line()
    out["checks"] = {k: {"value": v, "limit": cell.limits.get(k)}
                     for k, v in numbers.items()}
    return out


def run(root: str, name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: Optional[dict] = None) -> dict:
    """Set up, run the window, check the imports and the outputs; returns
    the result's line (raises ``ImportError`` where JAX was loaded)."""
    cell = Cell(root, name, seed, device, trace, overrides)
    rec = cell.window(seed, seconds)
    loaded = check.forbidden_modules()
    if loaded:
        raise ImportError("loaded in the run's process: " + ", ".join(loaded))
    t0 = time.perf_counter()
    sel = cell.selection(seed)
    cell.free()
    numbers = cell.numbers(sel)
    print(f"set-up {cell.setup_s:.3f} s (imports and configuration "
          f"{cell.import_s:.3f}, pipeline {cell.pipeline_build_s:.3f}, "
          f"first draw and warm-up {cell.warmup_s:.3f}), window "
          f"{rec['window_s']:.3f} s, check {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    if "profile" in rec:
        prof = rec["profile"]
        print(f"ranges hold {prof['ranged_us']:.1f} us of the ranges "
              f"stretch's busy {prof['ranges_busy_us']:.1f} us; attachments "
              f"dropped (host op <- device op, count, us): {prof['dropped']}",
              file=sys.stderr)
    return result(cell, rec, numbers, trace)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    entry = spec.workload(spec.load_benchmark(spec.ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    try:
        out = run(spec.ROOT, args.workload, args.seed, args.seconds,
                  bool(args.trace))
    except ImportError as err:
        print(err, file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']:.6g} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
