"""The program's own spans and counters over a cell's sweep: one process
sets the cell up with the benchmark's ranges, runs a traced window, then
runs the window's last chunk ``trace_chunks`` times more under
``torch.profiler`` with the program's spans and counters on
(:func:`benchmark.program.stretch`). It prints the stretch's summary to
standard error and one JSON line: each ``kx.*`` span's device ms a step,
its self time, the benchmark's range of the same work in the same stretch
and in the window's ranges stretch, the idle gaps by span, the counters
and the ratios read from them. With ``--cost N`` it times N pairs of
chunks with the spans on and with them off instead, with neither a
profiler nor the benchmark's ranges, and prints their ms a step.

    python3 -m benchmark.tools.spans --workload <cell> --seed <n> \\
        [--seconds 3] [--cost 0] [--scenarios N] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from benchmark import program, spec
from benchmark.run import Cell, card_line


def _ratio(counters, part: str, base: str, scale: float):
    """``scale`` times ``part`` over ``base``; None where ``base`` was not
    counted."""
    if not counters.get(base):
        return None
    return scale * counters.get(part, 0) / counters[base]


def profiled(cell: Cell, seed: int, seconds: float) -> dict:
    rec = cell.window(seed, seconds)
    again = cell.kept["last"] or cell.kept["start"]
    units = cell.traffic["trace_chunks"]
    prog = program.stretch(
        lambda: cell._chunk(again["sc"], again["carry_in"], again["offset"]),
        units, units * cell.traffic["chunk_steps"], cell.device)
    if prog is None:
        raise SystemExit("the program has no spans")
    print(program.summary(prog), file=sys.stderr)
    ms = lambda us, steps: {k: v / steps / 1e3 for k, v in us.items()}
    steps, counters = prog["steps"], prog["counters"]
    return {"span_ms": ms(prog["span_us"], steps),
            "self_ms": ms(prog["self_us"], steps),
            "range_ms": ms(prog["range_us"], steps),
            "window_range_ms": ms(rec["profile"]["stage_us"], rec["steps"]),
            "busy_ms": prog["busy_us"] / steps / 1e3,
            "device_ops_per_step": prog["device_ops"] / steps,
            "idle_ms": {k: s * 1e3 / steps for k, s in prog["idle_top"]},
            "counters": counters,
            "lifts_per_solve": _ratio(counters, "lift.rows", "step.rows", 1.0),
            "model_held_share": _ratio(counters, "model_guard.held",
                                       "model_guard.rows", 100.0),
            "cert_held_share": _ratio(counters, "terminal.held",
                                      "terminal.rows", 100.0)}


def cost(cell: Cell, pairs: int) -> dict:
    """ms a step of single chunks, timed with the device synchronized at
    both ends, spans off and on in turn (off first in even pairs)."""
    from koopmanx_torch.utils import profiling

    chunk = cell.traffic["chunk_steps"]
    offset = chunk % cell.episode
    carry = cell._chunk(cell.scenarios, None, 0)[0] if offset else None
    times = {False: [], True: []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            profiling.enable(on)
            profiling.synchronize(cell.device)
            t0 = time.perf_counter()
            cell._chunk(cell.scenarios, carry, offset)
            profiling.synchronize(cell.device)
            times[on].append((time.perf_counter() - t0) / chunk * 1e3)
    profiling.enable(False)
    off, on = statistics.median(times[False]), statistics.median(times[True])
    return {"ms_per_step_off": times[False], "ms_per_step_on": times[True],
            "median_off": off, "median_on": on, "on_over_off": on / off}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--cost", type=int, default=0,
                    help="pairs of chunks timed with the spans on and off")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scenarios", type=int, default=None,
                    help="a smaller fleet, for a rehearsal on the CPU")
    args = ap.parse_args(argv)
    small = (None if args.scenarios is None else
             {"scenarios": args.scenarios, "check_scenarios": args.scenarios})
    cell = Cell(spec.ROOT, args.workload, args.seed, device=args.device,
                trace=not args.cost, overrides=small)
    out = (cost(cell, args.cost) if args.cost
           else profiled(cell, args.seed, args.seconds))
    card = card_line() if cell.device.type == "cuda" else "cpu"
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "batch": cell.batch, **out, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
