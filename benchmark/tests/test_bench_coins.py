"""The teacher-forcing coins of the training cells: one generator for every seed, whose first draws,
the checked steps', teacher-force at the configurations' rate, and the warm-up's coin that feeds back."""

import json
import os

import pytest
import torch

import tiny
from benchlib import cells


@pytest.mark.parametrize("name", ["las_small", "las_large"])
def test_checked_steps_teacher_force(name):
    with open(os.path.join(tiny.BENCH, "configs", f"{name}.json")) as f:
        rate = json.load(f)["teacher_forcing_rate"]
    assert 0.0 < rate < 1.0
    assert all(c < rate for c in cells._coins(cells.CHECK_STEPS))
    fed_back = [c >= rate for c in cells._coins(400)]
    assert any(fed_back), "a window of a few hundred steps feeds back somewhere"
    assert float(torch.rand((), generator=cells._feedback_coins(rate))) >= rate


def test_coins_do_not_follow_the_seed():
    assert cells._coins(50) == cells._coins(50)
