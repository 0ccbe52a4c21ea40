"""The port's data parallelism (speech_recognition_tpu_torch.parallel, train/state.py) on
two spawned gloo ranks, against the one-process port step on the same global
batches and against JAX's step on a 2-device ``data`` mesh, float32 on the CPU.

- DeepSpeech2 (batch norm over the global batch), two Adam steps: loss rtol
  1e-5, every parameter and batch statistic rtol 1e-4 / atol 1e-5 (JAX's
  tolerances, tests/test_parallel.py:61-65).
- LAS at dropout 0 whose two halves hold different token counts (the CE is
  the global batch's masked mean): the same, with SGD (as JAX's own LAS mesh
  test: Adam's sign-like update would turn the pre-batch-norm biases'
  near-zero gradients into +-lr either way).
- The Conformer with hash dropout and K7's per-example seeds at 0.1: against
  the one-process step only (JAX's draws cannot be reproduced); a mask that
  differed in one element would move the loss far past 1e-5.  The masks
  themselves: a rank's offset mask is its rows of the global one, bit for bit.
- Two accumulated micro-steps (``optax.MultiSteps`` on the JAX side).
- LAS with dropout 0.2 (conv, input, decoder masks drawn at the global batch):
  against the one-process step.
- The multi-process dataset split: the port's sharded TSV and TFRecord readers
  equal JAX's for 2 and 3 shards, disjoint and covering, with ``skip``
  (tests/test_multihost.py:47-90).
"""

import os

import numpy as np
import pytest
import torch

from .const import SP_MODEL_LIBRI, TEST_CONFORMER_CONFIG, TEST_DATA_DIR, TEST_DS_CONFIG, TEST_LAS_CONFIG
from .torch_parallel_ref import CHANNELS, FREQ, ctc_batches, jax_steps, jax_variables, seq_batches
from .torch_ranks import assert_runs_match, run_ranks, specs_worker, train_steps

LAS_TOKENS = [7, 7, 3, 4]  # the first half of each batch holds far more labels than the second
SGD = 0.1
V = 256  # a narrow vocabulary keeps the spawned ranks' steps short


@pytest.fixture(scope="module")
def cases():
    """{name: (spec, flax model or None, JAX step kwargs)}."""
    import optax

    out = {}
    model, variables = jax_variables(TEST_DS_CONFIG, dropout=0.0, vocab_size=V)
    spec = dict(family="ds2", config=TEST_DS_CONFIG, overrides=dict(dropout=0.0, vocab_size=V), variables=variables,
                freq=FREQ, channels=CHANNELS, batches=ctc_batches(0, 2, vocab=V))
    out["ds2"] = (spec, model, {})
    out["ds2_accum"] = (dict(spec, accum=2, batches=ctc_batches(1, 2, vocab=V)), model, dict(accum=2))
    model, variables = jax_variables(TEST_LAS_CONFIG, tokens=6, dropout=0.0, teacher_forcing_rate=1.0, vocab_size=V)
    spec = dict(family="las", config=TEST_LAS_CONFIG, variables=variables, freq=FREQ, channels=CHANNELS, sgd=SGD,
                overrides=dict(dropout=0.0, teacher_forcing_rate=1.0, vocab_size=V),
                batches=seq_batches(2, 2, vocab=V, token_counts=LAS_TOKENS))
    out["las"] = (spec, model, dict(tx=optax.sgd(SGD), teacher=True))
    out["las_dropout"] = (dict(spec, overrides=dict(dropout=0.2, teacher_forcing_rate=0.5, vocab_size=V)), None, {})
    _, variables = jax_variables(TEST_CONFORMER_CONFIG, vocab_size=V)
    out["conformer_dropout"] = (dict(family="conformer", config=TEST_CONFORMER_CONFIG, variables=variables,
                                     overrides=dict(dropout=0.1, vocab_size=V), freq=FREQ, channels=CHANNELS,
                                     batches=ctc_batches(3, 2, vocab=V)), None, {})
    return out


@pytest.fixture(scope="module")
def two_ranks(cases, tmp_path_factory):
    names = list(cases)
    specs = [dict(cases[n][0], dp=2) for n in names]
    runs = run_ranks(specs_worker, 2, tmp_path_factory.mktemp("dp"), specs)
    return {n: [runs[0][i], runs[1][i]] for i, n in enumerate(names)}


@pytest.mark.parametrize("name", ["ds2", "las", "ds2_accum", "conformer_dropout", "las_dropout"])
def test_two_ranks_match_one_process(cases, two_ranks, name):
    spec = cases[name][0]
    one = train_steps(spec)
    rank0, rank1 = two_ranks[name]
    assert rank0["metrics"] == rank1["metrics"]  # every rank holds the global batch's metrics
    assert_runs_match(rank0, one)
    for key, value in rank0["state"].items():  # and the same parameters and statistics
        np.testing.assert_array_equal(rank1["state"][key], value, err_msg=key)


@pytest.mark.parametrize("name", ["ds2", "las", "ds2_accum"])
def test_two_ranks_match_jax_on_a_data_mesh(cases, two_ranks, name):
    spec, model, kwargs = cases[name]
    want = jax_steps(model, spec["variables"], spec["batches"], dp=2, **kwargs)
    assert_runs_match(two_ranks[name][0], want)


@pytest.mark.parametrize("rows", [(0, 3), (3, 3)])
def test_hash_dropout_offset_masks_are_rows_of_the_global_mask(rows):
    from speech_recognition_tpu_torch.ops.dropout import hash_dropout

    x = torch.ones(6, 5, 7)
    whole = hash_dropout(x, 1234, 0.3)
    lo, n = rows
    np.testing.assert_array_equal(hash_dropout(x[lo : lo + n], 1234, 0.3, lo).numpy(), whole[lo : lo + n].numpy())


# ------------------------------------------------------------ dataset split


def _write_tsv(path, n_rows, start=0):
    with open(path, "w") as f:
        f.write("FilePath\tText\n")
        for i in range(start, start + n_rows):
            f.write(f"audio_files/test.wav\trow {i}\n")


@pytest.mark.parametrize("count", [2, 3])
def test_tsv_shards_match_jax(tmp_path, count):
    from speech_recognition_tpu.data import get_dataset as jax_get_dataset
    from speech_recognition_tpu.data.tokenizer import SentencePieceTokenizer as JaxTokenizer
    from speech_recognition_tpu_torch.data import SentencePieceTokenizer, get_dataset

    os.symlink(os.path.join(TEST_DATA_DIR, "audio_files"), tmp_path / "audio_files")
    _write_tsv(tmp_path / "a.tsv", 3, start=0)
    _write_tsv(tmp_path / "b.tsv", 4, start=3)  # the stride continues across the file boundary
    paths = f"{tmp_path}/*.tsv"
    with open(SP_MODEL_LIBRI, "rb") as f:
        model = f.read()
    tok, jtok = SentencePieceTokenizer(model, add_bos=True, add_eos=True), JaxTokenizer(model, add_bos=True,
                                                                                       add_eos=True)

    def rows(get, tokenizer, **kw):
        return [tuple(t.tolist()) for _, t in get(paths, "wav", 16000, tokenizer, **kw)]

    full = rows(get_dataset, tok)
    assert len(full) == 7
    shards = [rows(get_dataset, tok, shard=(i, count)) for i in range(count)]
    for i, got in enumerate(shards):
        assert got == full[i::count] == rows(jax_get_dataset, jtok, shard=(i, count))
    assert sorted(sum(shards, [])) == sorted(full)
    assert rows(get_dataset, tok, shard=(1, count), skip=1) == full[1::count][1:] \
        == rows(jax_get_dataset, jtok, shard=(1, count), skip=1)


@pytest.mark.parametrize("count", [2, 3])
def test_tfrecord_shards_match_jax(tmp_path, count):
    from speech_recognition_tpu.data import get_tfrecord_dataset as jax_get_tfrecord_dataset
    from speech_recognition_tpu_torch.data import get_tfrecord_dataset
    from speech_recognition_tpu_torch.data.tfrecord import serialize_example, write_records

    path = str(tmp_path / "data.tfrecord")
    write_records(path, [serialize_example(np.full((4, 2, 1), i, np.float32), np.array([i, i + 1], np.int32))
                         for i in range(9)])

    def ids(get, **kw):
        return [int(t[0]) for _, t in get(path, **kw)]

    full = ids(get_tfrecord_dataset)
    assert full == list(range(9))
    shards = [ids(get_tfrecord_dataset, shard=(i, count)) for i in range(count)]
    for i, got in enumerate(shards):
        assert got == full[i::count] == ids(jax_get_tfrecord_dataset, shard=(i, count))
    assert sorted(sum(shards, [])) == full
    assert ids(get_tfrecord_dataset, shard=(count - 1, count), skip=1) == full[count - 1 :: count][1:] \
        == ids(jax_get_tfrecord_dataset, shard=(count - 1, count), skip=1)
