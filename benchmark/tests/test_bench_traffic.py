"""The traffic generator: deterministic per seed, the same valid audio for every seed, padded as the
port's run.train and run.inference pad."""

import numpy as np
import pytest
import torch

import tiny
from benchlib import traffic


@pytest.mark.parametrize("name", ["libri_train", "libri_decode_beam8", "libri_decode_greedy"])
def test_same_seed_same_pool(name):
    cfg, tr = tiny.tiny_config(), tiny.tiny_traffic(name)
    a = traffic.make_pool(tr, cfg, 2 ** 33 + 5, torch.device("cpu"))
    b = traffic.make_pool(tr, cfg, 2 ** 33 + 5, torch.device("cpu"))
    c = traffic.make_pool(tr, cfg, 2 ** 33 + 6, torch.device("cpu"))
    assert all(torch.equal(x.audio, y.audio) and torch.equal(x.lengths, y.lengths) for x, y in zip(a, b))
    assert not all(torch.equal(x.audio, y.audio) for x, y in zip(a, c))
    if tr["kind"] == "train":
        assert all(torch.equal(x.tokens, y.tokens) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["libri_train", "libri_decode_beam8"])
def test_every_seed_holds_the_same_audio(name):
    cfg, tr = tiny.tiny_config(), tiny.tiny_traffic(name)
    totals = set()
    for seed in (1, 2, 3, 2 ** 31 + 17):
        pool = traffic.make_pool(tr, cfg, seed, torch.device("cpu"))
        totals.add(round(sum(b.valid_audio_s for b in pool), 9))
        for b in pool:  # every batch holds the same lengths, in the seed's order
            assert sorted(b.lengths.tolist()) == sorted(pool[0].lengths.tolist())
            valid = (torch.arange(b.audio.shape[1])[None, :] < b.lengths[:, None].long())
            assert not b.audio[~valid].any()
    assert len(totals) == 1


def test_shipped_length_distributions_match_librispeech_means():
    for name, mean in (("libri_train", 12.7), ("libri_decode_beam8", 7.4)):
        tr = dict(tiny.tiny_traffic(name), batch_size=128)
        assert abs(traffic.batch_durations(tr).mean() - mean) < 0.1


def test_decode_pads_as_run_inference():
    from speech_recognition_tpu_torch.data.dataset import quantized_padded_raw_batch

    cfg = tiny.tiny_config()
    cfg["max_audio_length"] = 1024
    tr = tiny.tiny_traffic("libri_decode_greedy")
    cap = traffic.max_samples(cfg)
    for longest in (3000, 20480, 41000, 163999, 164000):
        lengths = np.array([400, longest, 1000])
        clips = [(np.ones(n, np.float32), np.zeros(1, np.int32)) for n in lengths]
        (audio, _), _, _ = next(quantized_padded_raw_batch(iter(clips), 3, cfg["frame_length"], cfg["frame_step"]))
        assert traffic.padded_samples(tr, cfg, lengths) == min(audio.shape[1], cap)


def test_train_pads_to_the_static_length_and_fills_transcripts():
    cfg, tr = tiny.tiny_config(), tiny.tiny_traffic("libri_train")
    pool = traffic.make_pool(tr, cfg, 9, torch.device("cpu"))
    for b in pool:
        assert b.audio.shape[1] == traffic.max_samples(cfg)
        assert (b.tokens[:, 0] == cfg["bos_id"]).all()
        assert ((b.tokens == cfg["eos_id"]).sum(dim=1) == 1).all()
        assert b.tokens.shape[1] == cfg["max_token_length"]
