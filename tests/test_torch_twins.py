"""Shared set-up for the PyTorch port's CPU tests, plus the port's import-isolation
and device-selection checks.

``las_twins`` builds one small LAS in both packages with the same weights:
the Flax model is initialized, its biases and BatchNorm statistics are
perturbed from a numpy seed (so the bridge moves non-trivial values), and
the torch model loads them through ``weights.params_from_jax``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models import LAS as JaxLAS
from speech_recognition_tpu_torch.configs import LASConfig
from speech_recognition_tpu_torch.models import LAS
from speech_recognition_tpu_torch.weights import params_from_jax

from .const import REPO_ROOT

V, H, ENC_LAYERS, DEC_LAYERS, FREQ, CHANNELS = 64, 16, 1, 2, 10, 3
BOS, EOS = 2, 3


@pytest.fixture
def one_device_mesh():
    """Register a 1-device mesh, so that the Pallas kernels run as one direct
    call (no shard_map) whatever mesh an earlier test left registered."""
    from speech_recognition_tpu.parallel import get_device_mesh
    from speech_recognition_tpu.parallel.mesh import set_active_mesh

    yield get_device_mesh(1, 1, devices=jax.devices()[:1])
    set_active_mesh(None)


def make_audio(batch=8, frames=24, seed=0):
    """Seeded features [B, T, F, C] with two zero-padded rows (row 0 from frame 12, row 3 from frame 6)."""
    audio = np.random.default_rng(seed).uniform(0.0, 10.0, (batch, frames, FREQ, CHANNELS)).astype(np.float32)
    audio[0, 12:] = 0.0
    audio[3, 6:] = 0.0
    return audio


def las_twins(vocab=V, seed=0, dtype=jnp.float32, vocab_scale=1.0):
    """(flax model, flax variables as numpy, torch LAS) sharing one set of weights."""
    model = JaxLAS("lstm", vocab, H, H, ENC_LAYERS, DEC_LAYERS, 0.0, 1.0, dtype=dtype)
    variables = model.init(
        {"params": jax.random.PRNGKey(seed)},
        (jnp.zeros((1, 24, FREQ, CHANNELS)), jnp.zeros((1, 8), jnp.int32)),
    )
    rng = np.random.default_rng(seed + 1)
    variables = jax.tree_util.tree_map(np.asarray, {k: variables[k] for k in ("params", "batch_stats")})

    def perturb(tree, path=()):
        for name, value in tree.items():
            if isinstance(value, dict):
                perturb(value, path + (name,))
            elif name == "bias":
                tree[name] = value + rng.normal(0.0, 0.1, value.shape).astype(np.float32)
            elif name == "mean":
                tree[name] = rng.normal(0.0, 0.2, value.shape).astype(np.float32)
            elif name == "var":
                tree[name] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)

    perturb(variables)
    ff = variables["params"]["attend_and_speller"]["feedforward"]
    ff["kernel"] = ff["kernel"] * np.float32(vocab_scale)
    config = LASConfig(rnn_type="lstm", vocab_size=vocab, encoder_hidden_dim=H, decoder_hidden_dim=H,
                       num_encoder_layers=ENC_LAYERS, num_decoder_layers=DEC_LAYERS, dropout=0.0,
                       teacher_forcing_rate=1.0, pad_id=0)
    torch_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    port = LAS(config, FREQ, CHANNELS, dtype=torch_dtype)
    port.load_state_dict(params_from_jax(variables))
    return model, variables, port


def test_port_imports_no_jax():
    """Every module of the port imports with jax/flax/optax/orbax blocked."""
    code = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import speech_recognition_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 10


def test_select_device_gpu_raises_without_cuda(monkeypatch):
    from speech_recognition_tpu_torch.run.common import select_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        select_device("GPU")
    assert select_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        select_device("TPU")


def test_kernel_wrappers_refuse_non_cpu_non_cuda():
    """A wrapper takes its plain version only for a CPU tensor; any other device
    must launch the kernel, which checks the operands and raises."""
    from speech_recognition_tpu_torch.kernels import check_operands

    with pytest.raises(ValueError, match="CUDA"):
        check_operands(torch.float32, hid=torch.zeros(2, 2, device="meta"))
