#!/bin/bash
# The round-3 KMAE sweep (tools/sweep_kmae_r3.sh) through the PyTorch
# port's tools/train_reference_scale_torch.py: the same four runs, each
# tagged <run>_torch so that the JAX sweep's artifacts stay as they are.
# Validation selection uses seed 3; the reported test rollout stays seed 2.
# Runs on the card; pass --cpu as the first argument for the CPU.
# Logs go to logs/kmae_sweep_torch/ (git-ignored), one per run, and the
# last line of each (its JSON record) to summary.jsonl there.
cd "$(dirname "$0")/.." || exit 1
L=logs/kmae_sweep_torch
mkdir -p "$L"
EXTRA=("$@")
run() {
  tag=$1; shift
  echo "=== $tag: $* ==="
  timeout 4000 python -u tools/train_reference_scale_torch.py --tag "$tag" "$@" \
    "${EXTRA[@]}" > "$L/$tag.log" 2>&1
  tail -1 "$L/$tag.log" >> "$L/summary.jsonl"
}
run r3a_torch --epochs 40 --rec-only-after none --cosine-final 0.01 --seed 0 --val-select --eval-every 4
run r3b_torch --epochs 40 --rec-only-after none --cosine-final 0.01 --seed 1 --val-select --eval-every 4
run r3c_torch --epochs 40 --rec-only-after 30 --cosine-final 0.01 --seed 0 --val-select --eval-every 4
run r3d_torch --epochs 40 --rec-only-after none --cosine-final 0.01 --seed 2 --val-select --eval-every 4
echo DONE_SWEEP
