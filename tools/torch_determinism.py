#!/usr/bin/env python3
"""Whether the port's train-step gradients are bit-reproducible on one CUDA GPU.

    python3 tools/torch_determinism.py [--model-config resources/configs/deepspeech_moe.yml] [--float32] \
        [--set moe_capacity_factor=8.0 ...] [--out build/determinism.json]

Seeded random weights of the model config (``--set key=value`` overrides a
field), one random batch of 128 rows of 1024 frames (``tools/torch_train_profile.py
make_batch``), bf16 unless ``--float32``.  The loss route's forward and
backward (the train step's, aux losses included, without the update) run
three times from the same weights with the same dropout seed, and each
parameter's gradient is compared bit for bit with the first run's; then
again with ``torch.backends.cudnn.deterministic`` on.  Prints the card's
name and power limit, then one JSON line (also written to ``--out``): for
each setting, the losses and the parameters whose gradient differed, each
with its largest difference over its largest magnitude.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from torch_train_profile import make_batch  # noqa: E402  (tools/ is the script's own directory)

RUNS, BATCH = 3, 128


def gradients(model, route, inputs, y_true, device, seed=2):
    """(loss, {name: gradient}) of one forward and backward of the loss route, dropout drawn from ``seed``."""
    import torch

    from speech_recognition_tpu_torch.train.state import _with_aux_loss

    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    loss, _ = route(inputs, y_true, True, gen)
    loss = _with_aux_loss(model, loss)
    loss.backward()
    grads = {name: p.grad.detach().clone() for name, p in model.named_parameters() if p.grad is not None}
    return float(loss.detach()), grads


def differing(first, other):
    """{name: max |difference| / max |first|} of the gradients that are not equal bit for bit."""
    import torch

    out = {}
    for name, g in first.items():
        if not torch.equal(g, other[name]):
            out[name] = float((g - other[name]).abs().max() / g.abs().max().clamp_min(1e-30))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-config", default="resources/configs/deepspeech_moe.yml",
                        help="a model config (relative to the repository root)")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override a model-config field (the value read as YAML)")
    parser.add_argument("--float32", action="store_true", help="float32 instead of bf16")
    parser.add_argument("--out", default="build/determinism.json")
    args = parser.parse_args()

    import torch

    from speech_recognition_tpu_torch.configs import DataConfig, LASConfig, TransducerConfig, get_model_config
    from speech_recognition_tpu_torch.run.common import create_model, select_device
    from speech_recognition_tpu_torch.train.state import LossRoute

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    dev = select_device("GPU")
    data_config = DataConfig.from_yaml(os.path.join(ROOT, "resources/configs/libri_config.yml"))
    overrides = {key: yaml.safe_load(value) for key, value in (item.split("=", 1) for item in args.set)}
    model_config = dataclasses.replace(get_model_config(os.path.join(ROOT, args.model_config)), **overrides)
    dtype = torch.float32 if args.float32 else torch.bfloat16
    model = create_model(model_config, data_config, dtype, dev, generator=torch.Generator().manual_seed(0),
                         train=True)
    route = LossRoute(model, model.get_loss_fn(), model.get_metrics())
    token_conditioned = isinstance(model_config, (LASConfig, TransducerConfig))
    inputs, y_true = make_batch(BATCH, 1024, data_config.max_token_length, torch.Generator().manual_seed(1), dev,
                                token_conditioned)
    if getattr(model, "logits_time_major_supported", False):
        y_true = y_true.t()
    result = {"card": card, "model_config": args.model_config, "overrides": overrides, "batch": BATCH,
              "dtype": str(dtype).removeprefix("torch.")}
    for setting in ("default", "cudnn_deterministic"):
        torch.backends.cudnn.deterministic = setting == "cudnn_deterministic"
        runs = [gradients(model, route, inputs, y_true, dev) for _ in range(RUNS)]
        diffs = [differing(runs[0][1], grads) for _, grads in runs[1:]]
        result[setting] = {"losses": [loss for loss, _ in runs], "parameters": len(runs[0][1]),
                           "differing": {name: max(d.get(name, 0.0) for d in diffs)
                                         for name in sorted(set().union(*diffs))}}
    torch.backends.cudnn.deterministic = False
    line = json.dumps(result)
    print(line)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
