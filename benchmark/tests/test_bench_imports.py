"""Nothing the harness runs imports JAX or the JAX package, by top-level name compared whole."""

import os
import subprocess
import sys

import tiny

BLOCKER = r'''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "speech_recognition_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
'''

DRIVE = r'''
import time, torch
sys.path[:0] = [{bench!r}, {repo!r}, {tests!r}]
import tiny, run
from benchlib.spec import load_cell
root = {root!r}
bench_json = tiny.make_data_dir(root)
for name in ("las_small.train", "las_small.decode_beam8", "las_large.decode_greedy"):
    cell = load_cell(name, bench_json, root + "/bench")
    run.run_cell(cell, 2 ** 31 + 3, 0.2, True, torch.device("cpu"), time.perf_counter())
import calibrate
print("FOUND", run.forbidden_modules())
'''


def test_forbidden_names_compared_whole(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "speech_recognition_tpu_torch_extra", sys)
    assert "speech_recognition_tpu_torch" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert run.forbidden_modules() == ["jaxlib"]


def test_a_run_imports_no_jax(tmp_path):
    code = BLOCKER + DRIVE.format(bench=tiny.BENCH, repo=tiny.REPO, tests=tiny.HERE, root=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=tiny.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_no_result_without_a_card_or_the_program(tmp_path):
    """Without CUDA the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, os.path.join(tiny.BENCH, "run.py"), "--workload", "las_small.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=tiny.REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
