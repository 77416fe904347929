#!/usr/bin/env python3
"""Pin an RBF preset's k-means centers in a ``.mat`` file.

    python3 tools/write_rbf_centers.py [--preset duffing_rbf128] \\
        [--out artifacts/duffing_rbf128_centers.mat]

Draws the preset's training snapshots and runs its k-means exactly as
``run.build_pipeline`` does at its set-up (the preset's seed, its data,
its dtype, on the CPU, in one thread: Lloyd's cluster sums are a matrix
product whose reduction order follows the thread count, so other counts
give centers a few ulps apart), and writes the centers, (nlift, n) in the preset's
dtype, under the key ``centers``. A configuration that sets
``lift.rbf_centers`` to the file's path (relative to the repo root) then
runs those centers wherever it runs, and a reader that cannot rerun the
port's generator (the benchmark's plain reference) reads the same ones.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def kmeans_centers(preset: str):
    """The centers the preset's own k-means gives at its set-up, in one
    intra-op thread."""
    import torch

    from koopmanx_torch import configs as C
    from koopmanx_torch.run import rbf_centers, training_snapshots

    cfg = C.PRESETS[preset]()
    if cfg.lift.kind != "rbf" or cfg.lift.rbf_centers != "kmeans":
        raise ValueError(f"{preset}: not an RBF lift with k-means centers")
    gen = torch.Generator().manual_seed(cfg.seed)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return rbf_centers(cfg, training_snapshots(cfg, gen), gen)
    finally:
        torch.set_num_threads(threads)


def main(argv=None) -> int:
    import scipy.io

    from koopmanx_torch.run import REPO_ROOT

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="duffing_rbf128")
    ap.add_argument("--out", default="artifacts/duffing_rbf128_centers.mat")
    args = ap.parse_args(argv)
    centers = kmeans_centers(args.preset)
    path = os.path.join(REPO_ROOT, args.out)
    scipy.io.savemat(path, {"centers": centers.numpy()})
    print(f"{args.out}: {args.preset} centers {tuple(centers.shape)} "
          f"{centers.dtype}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
