"""On the card: one cell run as the driver runs it, correct, and the fp32
control at the cell's own size, not correct."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(seed, *extra):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "star25.ring",
                          "--seed", str(seed), "--trace", "0", *extra],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
def test_cell_and_its_control_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = _run(2**31 + 3, "--seconds", "2")
    assert res["correct"] and res["device"]["platform"] == "gpu"
    for seed in (41, 42, 43):
        assert not _run(seed, "--seconds", "1", "--control", "fp32")["correct"]
