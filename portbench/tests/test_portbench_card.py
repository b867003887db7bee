"""On the card: a short run of each cell prints a correct result line.
Skips, inside its fixture, where there is no CUDA device."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ingest-vlog-bf16", "ingest-fastcut-fp32", "ingest-30fps-bf16"])
def test_cell_runs_correct(card, cell):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**31 + 101),
                        "--seconds", "5", "--trace", "1"], cwd=REPO, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
