"""The control (the reference in fp8 in the program's place) reads far above a sound run at a test
size.  At this size the sound program is float32, and a widest gap can catch a near tie either way,
so the greedy cell is read by its mean gap here, over a wider vocabulary and more requests: at 64 ids
and 3 requests the control can put every sampled token first as float32 does.  The control's readings at the cells' own sizes,
on the card, are in PERF.md (``calibrate.py``)."""

import time

import pytest
import torch

import tiny
from benchlib.spec import load_cell


@pytest.mark.parametrize("name,numbers,wider", [
    ("las_small.train", ("loss_rel", "grad_out_diff"), False),
    ("las_large.decode_greedy", ("greedy_mean_gap",), True),
    ("las_small.decode_beam8", ("beam_logppl_mean_gap", "beam_logppl_median_gap"), False),
])
def test_control_reads_above_a_sound_run(name, numbers, wider, tmp_path):
    import run

    root = str(tmp_path)
    cell = load_cell(name, tiny.make_data_dir(root), root + "/bench")
    if wider:
        cell.config["vocab_size"], cell.traffic["check_requests"] = 512, 12
    r = run.run_cell(cell, 2 ** 31 + 55, 0.3, False, torch.device("cpu"), time.perf_counter(), (), ("fp8",))
    for k in numbers:
        assert r.readings[f"control_fp8.{k}"] > 10 * max(r.readings[k], 1e-7), r.readings
