"""A run with the timed path broken underneath comes out not correct: the harness's look for a card
skipped, the rest of the run driven as run.py drives it, against the shipped limits."""

import json
import os
import time

import pytest
import torch

import tiny
from benchlib.spec import load_cell


def shipped_limits(name):
    with open(os.path.join(tiny.BENCH, "limits", f"{name}.json")) as f:
        return json.load(f)


def drive(name, faults, root):
    import run

    root = str(root)
    bench_json = tiny.make_data_dir(root, shipped_limits(name))
    cell = load_cell(name, bench_json, root + "/bench")
    r = run.run_cell(cell, 2 ** 31 + 901, 0.3, False, torch.device("cpu"), time.perf_counter(), faults)
    return run.result_line(cell, r, False, {"platform": "cpu", "kind": "cpu", "count": 1})


@pytest.mark.parametrize("name", ["las_large.train", "las_small.train"])
@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_training_fault_is_not_correct(name, fault, tmp_path):
    assert drive(name, (fault,), tmp_path)["correct"] is False


@pytest.mark.parametrize("name", ["las_large.train", "las_small.decode_beam8", "las_large.decode_greedy"])
def test_sound_run_is_correct(name, tmp_path):
    line = drive(name, (), tmp_path)
    assert line["correct"] is True, line["compared"]


def test_greedy_token_altered_is_not_correct(tmp_path):
    assert drive("las_large.decode_greedy", ("alter_token",), tmp_path)["correct"] is False


def test_beam_token_altered_where_produced_is_not_correct(monkeypatch, tmp_path):
    """The beam's step writes another token than the one it selected, and decodes on from it."""
    import speech_recognition_tpu_torch.ops.beam_search as bs

    update = bs.beam_update

    def altered(*args, **kwargs):
        tokens, logp, ended, eoslen = update(*args, **kwargs)
        step = args[7]
        if step == 2:
            tokens[:, :, step] = (tokens[:, :, step] + 1) % 64
        return tokens, logp, ended, eoslen

    monkeypatch.setattr(bs, "beam_update", altered)
    assert drive("las_small.decode_beam8", (), tmp_path)["correct"] is False
