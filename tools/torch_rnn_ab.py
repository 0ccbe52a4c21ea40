#!/usr/bin/env python3
"""Kernel K10 against the loops it replaced, on one CUDA GPU, in one process.

    python3 tools/torch_rnn_ab.py [--batch 128] [--out build/rnn_ab.json]

LAS-small (``las_small.yml``: 3 BiLSTM layers of 256, 255 frames) and
DeepSpeech2 (``deepspeech.yml``: 7 BiGRU layers of 128, 108 frames) at B
rows of 1024 random non-zero frames of ragged length, bf16, seeded random
weights.  Two variants of the no-grad recurrent layers, run in turns (loops,
K10, K10, loops):

- ``loops``: a no-grad ``lstm_scan`` / ``gru_scan`` runs the loops the port ran
  before K10: the LSTM's replayed as a CUDA graph
  (``GRAPHS.run(_lstm_forward)``) and the GRU's eagerly (``_gru_scan_core``);
- ``k10``: the port as it is (``ops/rnn_sequence.py``).

Per variant (CUDA events, median of 3 after a warm-up): the listener's
encode (LAS) or the log-probs (DS2), the whole greedy and beam-8 searches, and
one dev-pass batch (``make_eval_step``, as ``run.train``'s dev pass runs it).
Then DeepSpeech2's train step (``make_train_step``, median of 5 after 2
warm-ups) with the GRU's training loops eager and replayed as CUDA graphs
(``ops/rnn.py GRAPHS``), in turns (eager, graphs, graphs, eager).  Prints the
card's name and power limit first; writes everything to ``--out`` as JSON.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def cuda_ms(fn, reps=3):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class EagerGraphs:
    """A stand-in for ``ops/rnn.py GRAPHS`` that runs every loop eagerly."""

    @staticmethod
    def run(fn, *inputs):
        return fn(*inputs)


def parent_loops(rnn_type, x_proj, mask, rk, rb, h0, c0):
    """``rnn_sequence``'s contract computed by the no-grad loops of the port before K10."""
    from speech_recognition_tpu_torch.ops import rnn as rnn_mod

    if rnn_type == "lstm":
        return rnn_mod.GRAPHS.run(rnn_mod._lstm_forward, x_proj, mask, rk, h0, c0)
    out, h, _ = rnn_mod._gru_scan_core(x_proj, mask, rk, rb, h0, save=False)
    return out, h, None


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--out", default="build/rnn_ab.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    from speech_recognition_tpu_torch.configs import DataConfig, LASConfig, get_model_config
    from speech_recognition_tpu_torch.ops import rnn as rnn_mod
    from speech_recognition_tpu_torch.ops.rnn_sequence import rnn_sequence
    from speech_recognition_tpu_torch.run.common import create_model, make_searcher, select_device
    from speech_recognition_tpu_torch.train import (TrainState, linear_warmup_decay, make_adam, make_eval_step,
                                                    make_train_step)
    from torch_train_profile import make_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    dev = select_device("GPU")
    data_config = DataConfig.from_yaml(os.path.join(ROOT, "resources/configs/libri_config.yml"))
    B, L, frames = args.batch, data_config.max_token_length, 1024
    result = {"card": card, "batch": B, "frames": frames, "dtype": "bfloat16"}
    schedule = linear_warmup_decay(1000, 1e-3, 1e-5, 0.0, 10)

    for family, config_name in (("las", "las_small.yml"), ("ds2", "deepspeech.yml")):
        model_config = get_model_config(os.path.join(ROOT, "resources/configs", config_name))
        las = isinstance(model_config, LASConfig)
        model = create_model(model_config, data_config, torch.bfloat16, dev, generator=torch.Generator().manual_seed(0))
        state = TrainState(model, make_adam(model, schedule), schedule)
        eval_step = make_eval_step(model, model.get_loss_fn(), model.get_metrics())
        inputs, y_true = make_batch(B, frames, L, torch.Generator().manual_seed(1), dev, las)
        audio = inputs[0][0] if las else inputs[0]
        searcher = make_searcher(model, model_config, data_config, 1, 2)
        front = (lambda: searcher._encode(audio)) if las else (lambda: searcher._log_probs(audio))
        parts = {"encode" if las else "log_probs": front, "greedy": lambda: searcher.greedy_search(audio),
                 "beam8": lambda: searcher.beam_search(audio, 8), "dev_batch": lambda: eval_step(state, inputs, y_true)}
        runs = {"loops": [], "k10": []}
        for variant in ("loops", "k10", "k10", "loops"):
            rnn_mod.rnn_sequence = parent_loops if variant == "loops" else rnn_sequence
            rnn_sequence.launches = 0
            with torch.no_grad():  # as the searchers and the dev pass run
                runs[variant].append({name: cuda_ms(fn) for name, fn in parts.items()})
            if variant == "k10":
                runs[variant][-1]["k10_launches"] = rnn_sequence.launches
        rnn_mod.rnn_sequence = rnn_sequence
        result[family] = runs
        for variant, measured in runs.items():
            print(f"{family} {variant}: " + "; ".join(
                f"{k} " + " / ".join(f"{m[k]:.2f}" for m in measured) for k in measured[0]))

    model_config = get_model_config(os.path.join(ROOT, "resources/configs/deepspeech.yml"))
    model = create_model(model_config, data_config, torch.bfloat16, dev, generator=torch.Generator().manual_seed(0),
                         train=True)
    state = TrainState(model, make_adam(model, schedule), schedule)
    step = make_train_step(model, model.get_loss_fn(), model.get_metrics())
    inputs, y_true = make_batch(B, frames, L, torch.Generator().manual_seed(1), dev, False)
    gen = torch.Generator(device=dev).manual_seed(2)
    graphs = rnn_mod.GRAPHS
    steps = {"eager": [], "graphs": []}
    for variant in ("eager", "graphs", "graphs", "eager"):
        rnn_mod.GRAPHS = EagerGraphs() if variant == "eager" else graphs
        times = []
        for _ in range(7):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, inputs, y_true, gen)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        steps[variant].append(statistics.median(times[2:]))
    rnn_mod.GRAPHS = graphs
    result["ds2_train_step_ms"] = steps
    print("ds2 train step ms: " + "; ".join(f"{k} " + " / ".join(f"{t:.2f}" for t in v) for k, v in steps.items()))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
