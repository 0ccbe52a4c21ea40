"""The kernels' shared launch path (speech_recognition_tpu_torch/kernels/__init__.py ``launch``), on the CPU.

A C entry point sets its kernels' attributes, reads the device and launches
on the current CUDA device, so every wrapper calls it through ``launch``,
which makes the operands' device the current one for the call.  Here, without
a card:

- every C entry point of ``_SIGNATURES`` is called by some wrapper through
  ``launch("<name>", ...)``, and no module but ``kernels`` calls the library
  directly (read from the sources);
- ``launch`` calls the entry point with the device's stream under
  ``torch.cuda.device(<device>)`` (patched to record), and raises with the
  entry point's name when it returns an error.

- ``device_scope`` enters ``torch.cuda.device`` for a card and nothing for
  the CPU (gpipe's stages and the decode shards run under it).

That the guard puts a second card's launches on that card is unverified on a
one-card machine.
"""

import ast
import contextlib
import os

import pytest
import torch

import speech_recognition_tpu_torch as pkg
from speech_recognition_tpu_torch import kernels

PKG_DIR = os.path.dirname(pkg.__file__)


def _calls():
    """(module path, call node) of every call in the port's sources."""
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    tree = ast.parse(f.read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.Call):
                        yield os.path.relpath(path, PKG_DIR), node


def test_every_entry_point_launches_through_the_guard():
    launched, direct = set(), []
    for path, call in _calls():
        fn = call.func
        if isinstance(fn, ast.Name) and fn.id == "launch" and call.args:
            assert isinstance(call.args[0], ast.Constant), f"{path}:{call.lineno}: launch() of a computed name"
            launched.add(call.args[0].value)
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Call) and getattr(fn.value.func, "id", "") == \
                "library" and path != os.path.join("kernels", "__init__.py"):
            direct.append(f"{path}:{call.lineno} library().{fn.attr}")
    assert not direct, direct
    assert launched == set(kernels._SIGNATURES)


def test_launch_runs_the_entry_point_on_its_device(monkeypatch):
    current = [None]
    record = []

    @contextlib.contextmanager
    def device(d):
        prev, current[0] = current[0], d
        try:
            yield
        finally:
            current[0] = prev

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                record.append((name, args, current[0]))
                return 0 if args[0] else 5

            return entry

    monkeypatch.setattr(kernels, "library", lambda: Library())
    monkeypatch.setattr(kernels, "stream", lambda d: 1000 + d.index)
    monkeypatch.setattr(kernels, "error_string", lambda code: f"error {code}")
    monkeypatch.setattr(torch.cuda, "device", device)
    card = torch.device("cuda", 1)
    kernels.launch("rnn_sequence", card, 1, 2)
    assert record == [("rnn_sequence", (1, 2, 1001), card)] and current[0] is None
    with pytest.raises(RuntimeError, match="vocab_topk kernel launch failed: error 5"):
        kernels.launch("vocab_topk", card, 0)
    assert record[-1] == ("vocab_topk", (0, 1001), card) and current[0] is None


def test_device_scope_makes_a_card_current_and_leaves_the_cpu_alone(monkeypatch):
    entered = []

    @contextlib.contextmanager
    def device(d):
        entered.append(d)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    with kernels.device_scope(torch.device("cuda", 1)):
        pass
    with kernels.device_scope("cpu"):
        pass
    assert entered == [torch.device("cuda", 1)]
