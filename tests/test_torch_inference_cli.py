"""The port's inference CLI (speech_recognition_tpu_torch.run.inference) end to end on the
CPU: fixture wav audio, weights initialized by the JAX package and bridged to
a .pt state_dict, greedy and beam search.  The TSV's sentences must equal the
JAX searcher's on the same features (float32; vocab projection scaled x8 so
no token sits on a near-tie of the random-init logits)."""

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
from speech_recognition_tpu.search import LASSearcher as JaxSearcher
from speech_recognition_tpu_torch.run import inference
from speech_recognition_tpu_torch.weights import params_from_jax

from .const import SP_MODEL_LIBRI, TEST_DATA_DIR, TEST_LAS_CONFIG

MINI_CONFIG = f"{TEST_DATA_DIR}/mini_data_config.yml"


def _tsv_audio_paths():
    with open(f"{TEST_DATA_DIR}/wav_dataset.tsv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    return sorted({f"{TEST_DATA_DIR}/{row['FilePath']}" for row in rows})


@pytest.fixture(scope="module")
def jax_las(tmp_path_factory):
    config = DataConfig.from_yaml(MINI_CONFIG)
    model = get_model_config(TEST_LAS_CONFIG).create_model()
    variables = jax.tree_util.tree_map(np.asarray, build_variables(model, None, config, jax.random.PRNGKey(7)))
    ff = variables["params"]["attend_and_speller"]["feedforward"]
    ff["kernel"] = ff["kernel"] * np.float32(8.0)
    path = tmp_path_factory.mktemp("weights") / "las.pt"
    torch.save(params_from_jax(variables), path)
    return config, model, variables, str(path)


def _args(tmp_path, weights, beam, audio):
    return inference.parser.parse_args([
        "--data-config", MINI_CONFIG, "--model-config", TEST_LAS_CONFIG, "--audio-files", audio,
        "--model-path", weights, "--sp-model-path", SP_MODEL_LIBRI, "--output-path", str(tmp_path / "out.tsv"),
        "--batch-size", "2", "--beam-size", str(beam), "--device", "CPU",
    ])


@pytest.mark.parametrize("beam", [0, 3])
def test_cli_sentences_match_jax_searcher(tmp_path, jax_las, beam):
    config, model, variables, weights = jax_las
    (audio_path,) = _tsv_audio_paths()
    inference.main(_args(tmp_path, weights, beam, audio_path))
    with open(tmp_path / "out.tsv") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    assert rows[0] == ["AudioPath", "DecodedSentence"]
    assert [r[0] for r in rows[1:]] == [audio_path]

    audio = load_audio_file(config.sample_rate, config.file_format, config.sample_rate)(audio_path)
    feat = delta_accelerate(config.make_audio_feature_fn("numpy")(audio))
    batch, _, _ = next(quantized_padded_batch([(feat, np.zeros(1, np.int32))], 2))
    with open(SP_MODEL_LIBRI, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    bos, eos = tokenizer.tokenize("")
    searcher = JaxSearcher(model, variables, config.max_token_length, bos, eos)
    tokens = searcher.beam_search(batch, beam)[0][:, 0] if beam else searcher.greedy_search(batch)[0]
    want = tokenizer.detokenize([int(t) for t in np.asarray(tokens)[0]])
    assert rows[1][1] == want
    assert want.strip()


def test_cli_refuses_on_device_frontend(tmp_path, jax_las):
    args = _args(tmp_path, jax_las[3], 0, _tsv_audio_paths()[0])
    args.on_device_frontend = True
    with pytest.raises(NotImplementedError, match="not ported yet"):
        inference.main(args)
