"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, the numbers the comparison gives for the program (the
lower reading is their largest over the seeds) and for the control, the
reference in float32 with TF32 products put in the program's place (the
upper reading is their smallest). One process sets the cell up once and
runs a short window per seed.

    python3 -m benchmark.tools.readings --workload <cell> --seeds 12 \\
        [--first 1000003] [--seconds 3] [--control-seeds 3] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import sys

from benchmark import spec
from benchmark.reference import F64, TF32
from benchmark.run import Cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=1_000_003)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scenarios", type=int, default=None,
                    help="a smaller fleet, for a rehearsal on the CPU")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    small = (None if args.scenarios is None else
             {"scenarios": args.scenarios, "check_scenarios": args.scenarios})
    cell = Cell(spec.ROOT, args.workload, seeds[0], device=args.device,
                overrides=small)
    rows = []
    for i, seed in enumerate(seeds):
        cell.window(seed, args.seconds)
        sel = cell.selection(seed)
        del cell.kept
        row = {"seed": seed, "program": cell.numbers(sel, F64)}
        if i < args.control_seeds:
            row["control"] = cell.numbers(sel, TF32)
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = rows[0]["program"]
    lower = {k: max(r["program"][k] for r in rows) for k in names}
    upper = {k: min(r["control"][k] for r in rows if "control" in r)
             for k in names}
    summary = {"workload": args.workload, "seeds": seeds, "lower": lower,
               "upper": upper,
               "ratio": {k: upper[k] / lower[k] if lower[k] else None
                         for k in names}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows + [summary]:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
