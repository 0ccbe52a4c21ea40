"""The system under test, reached through the port's own entry points.

Training is ``train.state.make_train_step`` as ``run.train
--on-device-frontend`` builds it (``make_frontend_preprocess``, ``make_adam``,
a ``TrainState``), fed raw audio already on the card.  Decoding is the
on-device frontend (``ops.frontend.make_batch_frontend``) and the family's
searcher (``run.common.make_searcher``), as ``run.inference`` composes them.
The model is built on the meta device and given the benchmark's weights.
"""

from types import SimpleNamespace

import torch


def data_config(cfg: dict):
    from speech_recognition_tpu_torch.configs import DataConfig

    keys = ("file_format", "audio_feature_type", "sample_rate", "frame_length", "frame_step", "fft_length",
            "max_audio_length", "max_token_length", "use_delta_accelerate", "spec_augment", "num_mel_bins",
            "num_mfcc", "lower_edge_hertz", "upper_edge_hertz")
    return DataConfig(**{k: cfg[k] for k in keys})


def model_config(cfg: dict):
    from speech_recognition_tpu_torch.configs import LASConfig

    keys = ("rnn_type", "vocab_size", "encoder_hidden_dim", "decoder_hidden_dim", "num_encoder_layers",
            "num_decoder_layers", "dropout", "teacher_forcing_rate", "pad_id")
    return LASConfig(**{k: cfg[k] for k in keys})


def select_device(device: str) -> torch.device:
    """The port's device choice (``run.common.select_device``: TF32 off on the card)."""
    from speech_recognition_tpu_torch.run.common import select_device as select

    return select("GPU" if device == "cuda" else "CPU")


def build_model(cfg: dict, weights: dict, device, train: bool):
    """The port's LAS in the configuration's compute type, holding ``weights``."""
    from speech_recognition_tpu_torch.models import LAS

    dc = data_config(cfg)
    dtype = torch.bfloat16 if cfg["mixed_precision"] else torch.float32
    with torch.device("meta"):
        model = LAS(model_config(cfg), dc.frequency_dim, dc.feature_dim, dtype=dtype)
    model = model.to_empty(device=device)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in weights.items()}
    if got != want:
        raise RuntimeError(f"the program's LAS tree differs from the benchmark's: {sorted(set(got) ^ set(want))} "
                           f"{[k for k in got if k in want and got[k] != want[k]]}")
    model.load_state_dict(weights)
    return model.train(train)


def train_step(cfg: dict, model, lr: float, device):
    """(TrainState, step fn, dropout generator factory): the port's step with the on-device frontend."""
    from speech_recognition_tpu_torch.run.train import make_frontend_preprocess
    from speech_recognition_tpu_torch.train import TrainState, make_adam, make_train_step

    schedule = lambda _k: lr
    state = TrainState(model, make_adam(model, schedule), schedule)
    frontend_gen = torch.Generator(device=device).manual_seed(3)
    preprocess = make_frontend_preprocess(SimpleNamespace(data_config=data_config(cfg)), True, frontend_gen)
    step = make_train_step(model, model.get_loss_fn(), model.get_metrics(), preprocess)
    return state, step


def decoder(cfg: dict, model, search: str, beam_size: int):
    """fn(audio [B, S] on the card, lengths [B]) -> (best tokens [B, L], score [B]) on the card: greedy,
    the perplexity the searcher returns; beam, the best beam's log-probability as the searcher hands it
    to its last step, which turns it into a perplexity ``exp(logP)^(-1/len)``: in float32 that is
    infinite once logP is under about -104, as every long beam's is on seeded weights."""
    from speech_recognition_tpu_torch.ops.frontend import make_batch_frontend
    from speech_recognition_tpu_torch.run.common import make_searcher

    dc = data_config(cfg)
    searcher = make_searcher(model, model_config(cfg), dc, cfg["bos_id"], cfg["eos_id"])
    runner = SimpleNamespace(frontend=make_batch_frontend(dc, spec_augment=False), searcher=searcher, logp=None)
    if search == "beam":
        finish = searcher._finish_beams

        def keep_logp(tokens, logp):
            runner.logp = logp
            return finish(tokens, logp)

        searcher._finish_beams = keep_logp

    def decode(audio, lengths):
        feats, _ = runner.frontend(audio, lengths)
        if search == "beam":
            tokens, _ = runner.searcher.beam_search(feats, beam_size)
            return tokens[:, 0, :], runner.logp[:, 0]
        return runner.searcher.greedy_search(feats)

    return decode, runner
