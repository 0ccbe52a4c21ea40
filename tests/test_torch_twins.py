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

from .const import (REPO_ROOT, SP_MODEL_LIBRI, TEST_CONFORMER_CONFIG, TEST_DATA_DIR, TEST_DS_MOE_CONFIG,
                    TEST_LAS_CONFIG, TEST_TRANSDUCER_PRUNED_CONFIG, WAV_DATASET_PATH)

V, H, ENC_LAYERS, DEC_LAYERS, FREQ, CHANNELS = 64, 16, 1, 2, 10, 3
BOS, EOS = 2, 3


@pytest.fixture(scope="module", autouse=True)
def no_registered_mesh():
    """Start and end each port test module that imports this with no JAX mesh
    registered, so that the JAX side of a comparison runs unsharded whatever
    an earlier module on the same worker left registered."""
    from speech_recognition_tpu.parallel.mesh import set_active_mesh

    set_active_mesh(None)
    yield
    set_active_mesh(None)


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


def las_twins(vocab=V, seed=0, dtype=jnp.float32, vocab_scale=1.0, rnn_type="lstm"):
    """(flax model, flax variables as numpy, torch LAS) sharing one set of weights."""
    model = JaxLAS(rnn_type, vocab, H, H, ENC_LAYERS, DEC_LAYERS, 0.0, 1.0, dtype=dtype)
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
    config = LASConfig(rnn_type=rnn_type, vocab_size=vocab, encoder_hidden_dim=H, decoder_hidden_dim=H,
                       num_encoder_layers=ENC_LAYERS, num_decoder_layers=DEC_LAYERS, dropout=0.0,
                       teacher_forcing_rate=1.0, pad_id=0)
    torch_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    port = LAS(config, FREQ, CHANNELS, dtype=torch_dtype)
    port.load_state_dict(params_from_jax(variables))
    return model, variables, port


def test_port_imports_no_jax(tmp_path):
    """Every module of the port imports with jax/flax/optax/orbax and the JAX
    package (``speech_recognition_tpu``) blocked, and so do the imports that
    happen inside functions: the same process decodes the wav fixture through
    ``run.inference`` (once more with each batch's rows split over two CPU
    shards, ``run/common.py sharded_decode_fn``: the same TSV) and scores the
    tsv fixture through ``run.evaluate`` with a LAS mini checkpoint, and trains
    one step through
    ``run.train`` of the LAS, Conformer and pruned RNN-Transducer mini configs,
    of LAS with SpecAugment (the warp and both masks) in the on-device
    frontend, and of the DeepSpeech2-MoE mini config, then writes the tsv's
    TFRecords through ``run.make_tfrecord`` and trains LAS one step from them
    (``--use-tfrecord``), and LAS one step as a one-process ``--fsdp`` job over
    gloo (``parallel/``), all on the CPU.  ``parallel.pipeline`` and
    ``parallel.sequence`` are among the imported.  TensorFlow is blocked too:
    the LAS mini checkpoint goes to a reference TF checkpoint and back through
    ``compat/tf_checkpoint.py``'s command line, bit for bit.
    The transducer's modules (``models/transducer.py``,
    ``ops/transducer*.py``, ``ops/joint_planes.py``) are among the imported."""
    code = r"""
import importlib, importlib.machinery, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "speech_recognition_tpu")
ABSENT = ("tensorflow",)  # torch._dynamo probes its spec: found, with no origin, and fails to import
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        if name.split(".")[0] in ABSENT:
            return importlib.machinery.ModuleSpec(name, self)
    def create_module(self, spec):
        raise ImportError("blocked: " + spec.name)
    def exec_module(self, module):
        pass
sys.meta_path.insert(0, Block())
import torch
import speech_recognition_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("models.transducer", "ops.transducer", "ops.transducer_pruned", "ops.joint_planes", "ops.rnn_sequence",
             "run.evaluate", "models.moe", "ops.spec_augment", "ops.warp", "run.make_tfrecord", "data.tfrecord",
             "parallel", "parallel.mesh", "parallel.comm", "parallel.expert", "parallel.shard", "parallel.pipeline",
             "parallel.sequence", "compat", "compat.tensor_bundle", "compat.tf_checkpoint"):
    assert pkg.__name__ + "." + name in names, name

from speech_recognition_tpu_torch.configs import DataConfig, TrainConfig, get_model_config
from speech_recognition_tpu_torch.run import evaluate, inference, make_tfrecord, train
from speech_recognition_tpu_torch.run.common import create_model

out, data_config, las_config, conformer_config, transducer_config, moe_config, sp_model, tsv, wav = sys.argv[1:]
model = create_model(get_model_config(las_config), DataConfig.from_yaml(data_config), torch.float32,
                     torch.device("cpu"), generator=torch.Generator().manual_seed(0))
torch.save(model.state_dict(), out + "/las.pt")
from speech_recognition_tpu_torch.compat import tf_checkpoint
tf_checkpoint.main(["--export", out + "/las.pt", "--model-config", las_config, "--data-config", data_config,
                    "--output", out + "/tf/ckpt"])
tf_checkpoint.main(["--checkpoint", out + "/tf/ckpt", "--model-config", las_config, "--data-config", data_config,
                    "--output", out + "/las_from_tf.pt"])
back, want = torch.load(out + "/las_from_tf.pt"), model.state_dict()
assert set(back) == set(want) and all(torch.equal(back[k], want[k]) for k in want)
inference.main(inference.parser.parse_args([
    "--data-config", data_config, "--model-config", las_config, "--audio-files", wav, "--model-path",
    out + "/las.pt", "--sp-model-path", sp_model, "--output-path", out + "/decoded.tsv", "--batch-size", "2",
    "--device", "CPU"]))
from speech_recognition_tpu_torch.run import common
shards, real_split = [], common.sharded_decode_fn
def split_spy(*a, **k):
    fn, devices = real_split(*a, **k)
    shards.append(devices)
    return fn, devices
common.sharded_decode_fn, real_devices = split_spy, common.decode_devices
common.decode_devices = lambda device: [device, device]  # two CPU shards of one row each
inference.main(inference.parser.parse_args([
    "--data-config", data_config, "--model-config", las_config, "--audio-files", wav, "--model-path",
    out + "/las.pt", "--sp-model-path", sp_model, "--output-path", out + "/decoded_sharded.tsv", "--batch-size", "2",
    "--device", "CPU"]))
common.sharded_decode_fn, common.decode_devices = real_split, real_devices
assert shards == [[torch.device("cpu")] * 2], shards
assert open(out + "/decoded_sharded.tsv").read() == open(out + "/decoded.tsv").read()
assert evaluate.main(evaluate.parser.parse_args([
    "--data-config", data_config, "--model-config", las_config, "--dataset-paths", tsv, "--model-path",
    out + "/las.pt", "--sp-model-path", sp_model, "--output-path", out + "/scored.tsv", "--batch-size", "2",
    "--device", "CPU"])) == 0
import dataclasses
steps = []
for model_config, spec_augment in ((las_config, False), (conformer_config, False), (transducer_config, False),
                                   (las_config, True), (moe_config, False)):
    cfg = TrainConfig(
        data_config=data_config, model_config=model_config, sp_model_path=sp_model, train_dataset_paths=tsv,
        dev_dataset_paths=tsv, train_dataset_size=2, output_path=out + "/train", epochs=1, steps_per_epoch=1,
        learning_rate=1e-3, batch_size=2, dev_batch_size=2, shuffle_buffer_size=1, max_over_policy="slice",
        device="CPU", seed=1, on_device_frontend=spec_augment)
    if spec_augment:  # the warp and both masks, in the on-device frontend
        cfg.data_config = dataclasses.replace(cfg.data_config, spec_augment=dataclasses.replace(
            cfg.data_config.spec_augment, enable=True, W=5))
    records = train.main(cfg)
    steps.append(records[0]["steps"])
make_tfrecord.main(make_tfrecord.parser.parse_args([
    "--data-config", data_config, "--dataset-paths", tsv, "--output-dir", out, "--sp-model-path", sp_model]))
cfg = TrainConfig(
    data_config=data_config, model_config=las_config, sp_model_path=sp_model, train_dataset_paths=out + "/wav_dataset.tfrecord",
    dev_dataset_paths=out + "/wav_dataset.tfrecord", train_dataset_size=2, output_path=out + "/train_tfrecord", epochs=1,
    steps_per_epoch=1, learning_rate=1e-3, batch_size=2, dev_batch_size=2, shuffle_buffer_size=1, max_over_policy="slice",
    device="CPU", seed=1, use_tfrecord=True)
steps.append(train.main(cfg)[0]["steps"])
import socket
with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
cfg = TrainConfig(
    data_config=data_config, model_config=las_config, sp_model_path=sp_model, train_dataset_paths=tsv,
    dev_dataset_paths=tsv, train_dataset_size=2, output_path=out + "/train_fsdp", epochs=1, steps_per_epoch=1,
    learning_rate=1e-3, batch_size=2, dev_batch_size=2, shuffle_buffer_size=1, max_over_policy="slice",
    device="CPU", seed=1, fsdp=True, coordinator_address=f"127.0.0.1:{port}", num_processes=1, process_id=0)
steps.append(train.main(cfg)[0]["steps"])  # one process over gloo, FSDP2 and the gathered checkpoint
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED + ABSENT]
print(len(names), sum(steps))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = [str(tmp_path), f"{TEST_DATA_DIR}/mini_data_config.yml", TEST_LAS_CONFIG, TEST_CONFORMER_CONFIG,
            TEST_TRANSDUCER_PRUNED_CONFIG, TEST_DS_MOE_CONFIG, SP_MODEL_LIBRI, WAV_DATASET_PATH,
            f"{TEST_DATA_DIR}/audio_files/test.wav"]
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    n_modules, steps = out.stdout.split()[-2:]
    assert int(n_modules) >= 30 and int(steps) == 7
    assert (tmp_path / "decoded.tsv").read_text().startswith("AudioPath\tDecodedSentence")
    assert (tmp_path / "scored.tsv").read_text().startswith("Prediction\tTarget\tWER\tCER")


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
