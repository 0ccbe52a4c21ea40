"""A tiny copy of the benchmark's data for CPU tests: the shipped configurations' keys at toy sizes."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

TINY = {"encoder_hidden_dim": 16, "decoder_hidden_dim": 16, "num_encoder_layers": 2, "vocab_size": 64,
        "max_audio_length": 64, "max_token_length": 12, "num_mel_bins": 20, "mixed_precision": False}
TRAFFIC = {"batch_size": 4, "pool_batches": 3, "trace_steps": 2, "trace_batches": 2, "check_requests": 3,
           "tokens_per_s": 6.0}


def tiny_config(name="las_small"):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    return cfg


def tiny_traffic(name):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        t = json.load(f)
    t.update(TRAFFIC)
    return t


def make_data_dir(root, limits=None):
    """A benchmark folder under ``root`` with the shipped metrics and tiny configurations and traffic;
    returns the path of its BENCHMARK.json."""
    data = os.path.join(root, "bench")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(data, sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(data, "metrics"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        with open(os.path.join(data, "configs", f"{c['name']}.json"), "w") as f:
            json.dump(tiny_config(c["name"]), f)
        c["file"] = f"bench/configs/{c['name']}.json"
    for t in {w["traffic"] for w in bench["workloads"]}:
        with open(os.path.join(data, "traffic", f"{t}.json"), "w") as f:
            json.dump(tiny_traffic(t), f)
    for w in bench["workloads"]:
        with open(os.path.join(data, "limits", f"{w['name']}.json"), "w") as f:
            json.dump(limits if limits is not None else {}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path
