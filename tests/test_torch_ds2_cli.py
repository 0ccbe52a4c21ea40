"""DeepSpeech2 through the port's CLIs (speech_recognition_tpu_torch.run.train and
run.inference) on the CPU fixtures.

- ``run.inference`` with weights initialized by the JAX package and bridged
  to a .pt state_dict: greedy and beam-3 sentences equal the JAX
  ``DeepSpeechSearcher``'s on the same features (float32; vocab projection
  scaled x8 so no frame's argmax sits on a near-tie).
- ``run.train`` on tests/data/wav_dataset.tsv: finite train and dev losses,
  a ``.pt`` named as the JAX package names DS2 checkpoints, which
  ``run.inference`` then loads, greedy and beam.
"""

import csv

import jax
import numpy as np
import pytest
import torch

from speech_recognition_tpu.configs import DataConfig, get_model_config
from speech_recognition_tpu.data import SentencePieceTokenizer, load_audio_file
from speech_recognition_tpu.data.dataset import quantized_padded_batch
from speech_recognition_tpu.ops.features import delta_accelerate
from speech_recognition_tpu.run.common import build_variables
from speech_recognition_tpu.search import DeepSpeechSearcher as JaxSearcher
from speech_recognition_tpu_torch.configs import TrainConfig
from speech_recognition_tpu_torch.run import inference
from speech_recognition_tpu_torch.run import train as train_cli
from speech_recognition_tpu_torch.weights import params_from_jax

from .const import SP_MODEL_LIBRI, TEST_DATA_DIR, TEST_DS_CONFIG, WAV_DATASET_PATH

MINI_CONFIG = f"{TEST_DATA_DIR}/mini_data_config.yml"
AUDIO = f"{TEST_DATA_DIR}/audio_files/test.wav"


@pytest.fixture(scope="module")
def jax_ds2(tmp_path_factory):
    config = DataConfig.from_yaml(MINI_CONFIG)
    model = get_model_config(TEST_DS_CONFIG).create_model()
    variables = jax.tree_util.tree_map(np.asarray, build_variables(model, None, config, jax.random.PRNGKey(5)))
    fc = variables["params"]["fully_connected"]
    fc["kernel"] = fc["kernel"] * np.float32(8.0)
    path = tmp_path_factory.mktemp("weights") / "ds2.pt"
    torch.save(params_from_jax(variables), path)
    return config, model, variables, str(path)


def _decode(tmp_path, weights, beam, model_config=TEST_DS_CONFIG):
    out = tmp_path / f"out{beam}.tsv"
    inference.main(inference.parser.parse_args([
        "--data-config", MINI_CONFIG, "--model-config", model_config, "--audio-files", AUDIO,
        "--model-path", weights, "--sp-model-path", SP_MODEL_LIBRI, "--output-path", str(out),
        "--batch-size", "2", "--beam-size", str(beam), "--device", "CPU",
    ]))
    with open(out) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    assert rows[0] == ["AudioPath", "DecodedSentence"] and [r[0] for r in rows[1:]] == [AUDIO]
    return rows[1][1]


def jax_sentence(config, model, variables, beam):
    """The JAX ``DeepSpeechSearcher``'s sentence for the wav fixture (greedy, or the best beam)."""
    audio = load_audio_file(config.sample_rate, config.file_format, config.sample_rate)(AUDIO)
    feat = delta_accelerate(config.make_audio_feature_fn("numpy")(audio))
    batch, _, _ = next(quantized_padded_batch([(feat, np.zeros(1, np.int32))], 2))
    searcher = JaxSearcher(model, variables, 14)
    tokens = searcher.beam_search(batch, beam)[0][:, 0] if beam else searcher.greedy_search(batch)[0]
    with open(SP_MODEL_LIBRI, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    return tokenizer.detokenize([int(t) for t in np.asarray(tokens)[0]])


@pytest.mark.parametrize("beam", [0, 3])
def test_cli_sentences_match_jax_searcher(tmp_path, jax_ds2, beam):
    config, model, variables, weights = jax_ds2
    got = _decode(tmp_path, weights, beam)
    want = jax_sentence(config, model, variables, beam)
    assert got == want and want.strip()


def test_train_cli_writes_a_checkpoint_that_inference_loads(tmp_path):
    cfg = TrainConfig(
        data_config=MINI_CONFIG, model_config=TEST_DS_CONFIG, sp_model_path=SP_MODEL_LIBRI,
        train_dataset_paths=WAV_DATASET_PATH, dev_dataset_paths=WAV_DATASET_PATH, train_dataset_size=2,
        output_path=str(tmp_path / "out"), epochs=1, steps_per_epoch=2, learning_rate=1e-3, batch_size=2,
        dev_batch_size=2, shuffle_buffer_size=1, max_over_policy="slice", device="CPU", seed=42,
    )
    (record,) = train_cli.main(cfg)
    assert record["steps"] == 2 and np.isfinite(record["loss"]) and np.isfinite(record["val_loss"])
    assert "accuracy" not in record and "val_accuracy" not in record
    ckpt = record["checkpoint"]
    assert ckpt.endswith("loss.pt") and "/models/model-1epoch-" in ckpt
    state = torch.load(ckpt, weights_only=True)
    assert "recurrent.reccurent_layer1.backward_rnn.cell.bias" in state
    assert "recurrent.batch_normalization0.running_var" in state
    for beam in (0, 2):
        _decode(tmp_path, ckpt, beam)
