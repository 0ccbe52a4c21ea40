"""The port's train CLI as two real processes (``--coordinator-address``, gloo, ``--device CPU``),
mirroring tests/test_multihost_process.py:155-215 for the JAX CLI.

- The job (8 rows, DeepSpeech2 mini at dropout 0, batch 8, one step an epoch,
  two epochs) over two processes: every rank reads its stride of the rows and
  the whole dev set, both log the same global val_loss, which equals a
  one-process run's within rel 2e-3 (the two-process global batch is a stride
  permutation of the one-process batch, as in the JAX test); rank 0 alone
  writes the checkpoints and the TensorBoard logs; JAX's log lines.
- ``--auto-resume`` over a shared output directory: both ranks read the
  checkpoint rank 0 wrote and train only the remaining epoch.
- The bootstrap's backend: NCCL for every rank on the card, whatever the job's
  size against one host's cards (two hosts of eight cards: sixteen ranks); a
  process that joined its job already keeps its group (a one-card harness
  joins over gloo), and one that joined as another rank is refused.
Each process runs under its own timeout.
"""

import logging
import os
import re
import socket
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from .const import SP_MODEL_LIBRI, TEST_DATA_DIR

MINI_DATA_CONFIG = os.path.join(TEST_DATA_DIR, "mini_data_config.yml")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESS_TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mh_job")
    os.symlink(os.path.join(TEST_DATA_DIR, "audio_files"), root / "audio_files")
    tsv = root / "train.tsv"
    with open(tsv, "w") as f:
        f.write("FilePath\tText\n")
        for i in range(8):
            f.write(f"audio_files/test.wav\tthis is row number {i}\n")
    model_cfg = root / "ds_mini_nodrop.yml"
    model_cfg.write_text(
        "model_name: deepspeech2\nnum_conv_layers: 2\nchannels: [8, 8]\n"
        "kernel_sizes:\n  - [11, 5]\n  - [7, 3]\nstrides:\n  - [3, 2]\n  - [2, 2]\n"
        "rnn_type: gru\nnum_reccurent_layers: 2\nhidden_dim: 16\ndropout: 0.0\nrecurrent_dropout: 0.0\n"
        "vocab_size: 16000\nblank_index: 14\npad_index: 0\n"
    )
    return str(tsv), str(model_cfg)


def _args(tsv, model_cfg, out, epochs, extra=()):
    return ["--data-config", MINI_DATA_CONFIG, "--model-config", model_cfg, "--sp-model-path", SP_MODEL_LIBRI,
            "--train-dataset-paths", tsv, "--dev-dataset-paths", tsv, "--train-dataset-size", "8",
            "--output-path", out, "--epochs", str(epochs), "--steps-per-epoch", "1", "--learning-rate", "1e-3",
            "--batch-size", "8", "--dev-batch-size", "8", "--shuffle-buffer-size", "1", "--max-over-policy", "slice",
            "--device", "CPU", "--seed", "42", *extra]


def _launch(arg_lists, log_dir):
    """Run the port's train CLI once per argument list, all at once; each under its own timeout."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs, paths = [], []
    for i, args in enumerate(arg_lists):
        paths.append(os.path.join(log_dir, f"proc{i}.log"))
        with open(paths[-1], "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-m", "speech_recognition_tpu_torch.run.train", *args],
                                          cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=PROCESS_TIMEOUT))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            rcs.append("timeout")
    outs = [open(path).read() for path in paths]
    assert rcs == [0] * len(procs), f"rcs {rcs}:\n" + "\n---\n".join(o[-3000:] for o in outs)
    return outs


def _launch_two(args_for, log_dir):
    port = _free_port()
    return _launch([args_for(pid) + ["--coordinator-address", f"127.0.0.1:{port}", "--num-processes", "2",
                                     "--process-id", str(pid)] for pid in range(2)], log_dir)


def _val_losses(text):
    return [float(m) for m in re.findall(r"\d+ epoch \| .*val_loss: ([0-9.]+)", text)]


def test_two_process_train_matches_single_process(job, tmp_path):
    tsv, model_cfg = job
    port = _free_port()
    # the one-process reference and the two ranks run at once
    single, *outs = _launch([_args(tsv, model_cfg, str(tmp_path / "single"), epochs=2)] + [
        _args(tsv, model_cfg, str(tmp_path / f"mh{pid}"), epochs=2) + [
            "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(pid)]
        for pid in range(2)], str(tmp_path))
    single_losses = _val_losses(single)
    assert len(single_losses) == 2
    assert "Distributed: process 0/2" in outs[0]
    assert "Multi-host: process 1/2" in outs[1]
    assert "SPMD over mesh {'data': 2, 'model': 1}" in outs[0]
    mh_losses = _val_losses(outs[0])
    assert len(mh_losses) == 2
    assert _val_losses(outs[1]) == mh_losses  # both ranks log the global batch's metrics
    assert mh_losses == pytest.approx(single_losses, rel=2e-3)

    assert len(os.listdir(tmp_path / "mh0" / "models")) == 2
    p1_models = tmp_path / "mh1" / "models"
    assert not p1_models.exists() or not os.listdir(p1_models), "rank 1 must not checkpoint"
    p1_logs = tmp_path / "mh1" / "logs"
    assert not p1_logs.exists() or not any(n.startswith("events") for n in os.listdir(p1_logs))


def test_two_process_auto_resume_shared_dir(job, tmp_path):
    tsv, model_cfg = job
    shared = str(tmp_path / "shared")
    _launch_two(lambda pid: _args(tsv, model_cfg, shared, epochs=1), str(tmp_path))
    assert len(os.listdir(os.path.join(shared, "models"))) == 1

    (tmp_path / "r2").mkdir()
    outs = _launch_two(lambda pid: _args(tsv, model_cfg, shared, epochs=2, extra=("--auto-resume",)),
                       str(tmp_path / "r2"))
    assert len(os.listdir(os.path.join(shared, "models"))) == 2
    for out in outs:
        assert "Auto-resume from" in out and "skip_epochs=1" in out
        assert len(_val_losses(out)) == 1  # only epoch 2 ran


def _job_cfg(device, processes, pid):
    return SimpleNamespace(device=device, num_processes=processes, process_id=pid,
                           coordinator_address="10.0.0.1:29500")


@pytest.mark.parametrize("pid", [0, 3, 8, 15])
def test_bootstrap_takes_nccl_on_the_card_for_a_two_host_job(monkeypatch, pid):
    """Sixteen ranks on two hosts of eight cards: every rank joins over NCCL on card ``pid % 8``."""
    import torch.distributed as dist

    from speech_recognition_tpu_torch.run.train import bootstrap

    joined, current = [], []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: joined.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    device = bootstrap(_job_cfg("GPU", 16, pid), logging.getLogger("test"))
    assert device == torch.device("cuda", pid % 8) and current == [pid % 8]
    ((backend, kw),) = joined
    assert backend == "nccl" and kw["device_id"] == device
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("tcp://10.0.0.1:29500", 16, pid)


def test_bootstrap_keeps_a_process_group_joined_before_it(tmp_path):
    import torch.distributed as dist

    from speech_recognition_tpu_torch.run.train import bootstrap

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        assert bootstrap(_job_cfg("CPU", 1, 0), logging.getLogger("test")) == torch.device("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        with pytest.raises(ValueError, match="joined its job as process 0/1"):
            bootstrap(_job_cfg("CPU", 2, 1), logging.getLogger("test"))
    finally:
        dist.destroy_process_group()
