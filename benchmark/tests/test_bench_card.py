"""One cell through the command on a card (marked ``cuda``: skips without one)."""

import json
import os
import subprocess
import sys

import pytest

import tiny


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")
    out = subprocess.run([sys.executable, os.path.join(tiny.BENCH, "run.py"), "--workload", "las_small.decode_beam8",
                          "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"], capture_output=True,
                         text=True, timeout=900, cwd=tiny.REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
