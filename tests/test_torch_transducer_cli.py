"""The RNN-Transducer through the port's CLIs (speech_recognition_tpu_torch.run.train and
run.inference) on the CPU fixtures, with ``transducer_mini_for_test.yml``
and ``transducer_pruned_mini_for_test.yml`` (S=2).

- ``run.inference`` with seeded weights as a .pt state_dict, bridged to a
  Flax tree for the JAX package: greedy and beam-3 sentences equal the JAX
  ``TransducerSearcher``'s on the same features (float32; joint kernel
  scaled x16 so no step's argmax sits on a near-tie).
- ``run.train`` of the pruned config (the shipped objective; the dense loss
  is held against JAX's train step in tests/test_torch_transducer.py) on
  tests/data/wav_dataset.tsv: finite train and dev losses and a ``.pt`` named
  as the JAX package names transducer checkpoints, which ``run.inference``
  then loads, greedy and beam.
"""

import numpy as np
import pytest
import torch

from speech_recognition_tpu.configs import DataConfig, get_model_config
from speech_recognition_tpu.data import SentencePieceTokenizer, load_audio_file
from speech_recognition_tpu.data.dataset import quantized_padded_batch
from speech_recognition_tpu.ops.features import delta_accelerate
from speech_recognition_tpu.search import TransducerSearcher as JaxSearcher
from speech_recognition_tpu_torch import configs as port_configs
from speech_recognition_tpu_torch.configs import TrainConfig
from speech_recognition_tpu_torch.run import train as train_cli
from speech_recognition_tpu_torch.run.common import create_model
from speech_recognition_tpu_torch.weights import params_to_jax

from .const import SP_MODEL_LIBRI, TEST_TRANSDUCER_CONFIG, TEST_TRANSDUCER_PRUNED_CONFIG, WAV_DATASET_PATH
from .test_torch_ds2_cli import AUDIO, MINI_CONFIG
from .test_torch_ds2_cli import _decode as decode
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def jax_transducer(tmp_path_factory):
    port = create_model(port_configs.get_model_config(TEST_TRANSDUCER_CONFIG),
                        port_configs.DataConfig.from_yaml(MINI_CONFIG), torch.float32, torch.device("cpu"),
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        port.joint_kernel.mul_(16.0)
    path = tmp_path_factory.mktemp("weights") / "transducer.pt"
    torch.save(port.state_dict(), path)
    model = get_model_config(TEST_TRANSDUCER_CONFIG).create_model()
    return DataConfig.from_yaml(MINI_CONFIG), model, params_to_jax(port.state_dict()), str(path)


def jax_sentence(config, model, variables, beam):
    """The JAX ``TransducerSearcher``'s sentence for the wav fixture (greedy, or the best beam)."""
    audio = load_audio_file(config.sample_rate, config.file_format, config.sample_rate)(AUDIO)
    feat = delta_accelerate(config.make_audio_feature_fn("numpy")(audio))
    batch, _, _ = next(quantized_padded_batch([(feat, np.zeros(1, np.int32))], 2))
    with open(SP_MODEL_LIBRI, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    bos, eos = tokenizer.tokenize("")
    searcher = JaxSearcher(model, variables, config.max_token_length, bos, eos, 0)
    tokens = searcher.beam_search(batch, beam)[0][:, 0] if beam else searcher.greedy_search(batch)[0]
    return tokenizer.detokenize([int(t) for t in np.asarray(tokens)[0]])


@pytest.mark.parametrize("beam", [0, 3])
def test_cli_sentences_match_jax_searcher(tmp_path, jax_transducer, beam):
    config, model, variables, weights = jax_transducer
    got = decode(tmp_path, weights, beam, TEST_TRANSDUCER_CONFIG)
    assert got == jax_sentence(config, model, variables, beam) and got.strip()


def test_train_cli_writes_a_checkpoint_that_inference_loads(tmp_path):
    cfg = TrainConfig(
        data_config=MINI_CONFIG, model_config=TEST_TRANSDUCER_PRUNED_CONFIG, sp_model_path=SP_MODEL_LIBRI,
        train_dataset_paths=WAV_DATASET_PATH, dev_dataset_paths=WAV_DATASET_PATH, train_dataset_size=2,
        output_path=str(tmp_path / "out"), epochs=1, steps_per_epoch=2, learning_rate=1e-3, batch_size=2,
        dev_batch_size=2, shuffle_buffer_size=1, max_over_policy="slice", device="CPU", seed=42,
    )
    (record,) = train_cli.main(cfg)
    assert record["steps"] == 2 and np.isfinite(record["loss"]) and np.isfinite(record["val_loss"])
    assert 0.0 < record["loss"] < 1e4 and "accuracy" not in record
    ckpt = record["checkpoint"]
    assert ckpt.endswith("loss.pt") and "/models/model-1epoch-" in ckpt
    state = torch.load(ckpt, weights_only=True)
    assert state["joint_kernel"].shape == (24, 16000) and state["pred_proj.weight"].shape == (24, 16)
    assert "pred_layer0.cell.recurrent_kernel" in state and "block1.mhsa.qkv.weight" in state
    for beam in (0, 2):
        decode(tmp_path, ckpt, beam, TEST_TRANSDUCER_PRUNED_CONFIG)
