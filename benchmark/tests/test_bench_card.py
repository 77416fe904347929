"""On the card: one short run of each cell through the command, its line
as the contract has it. Skipped without a CUDA card."""
import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.mark.card
@pytest.mark.parametrize("cell", ["duffing.sweep-256k", "revise2.sweep-64k"])
def test_a_short_run_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          cell, "--seed", str(2**32 + 5), "--seconds", "2",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert "setup_s" in line["metrics"]
