"""A cell, a traffic mix and a per-layer metric are added by files and BENCHMARK.json entries alone."""

import json
import os
import time

import torch

import tiny
from benchlib.spec import load_cell

METRIC = '''
"""served_batches: the traced batches (a metric a later change could add)."""
SPANS = ({"label": "search_extra", "function": "speech_recognition_tpu_torch.search:greedy_search"},)


def read(trace):
    return float(trace.calls("search_extra")) or None
'''


def test_new_files_make_a_new_cell(tmp_path):
    import run

    root = str(tmp_path)
    bench_json = tiny.make_data_dir(root)
    data = os.path.join(root, "bench")
    traffic = tiny.tiny_traffic("libri_decode_greedy")
    traffic.update(batch_size=2, duration_s={"quantiles": [[0.0, 0.2], [1.0, 0.6]]})
    with open(os.path.join(data, "traffic", "short_greedy.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(data, "metrics", "served_batches.py"), "w") as f:
        f.write(METRIC)
    with open(os.path.join(data, "limits", "las_small.short_greedy.json"), "w") as f:
        json.dump({"greedy_logit_gap": 1e-5}, f)
    with open(bench_json) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "las_small.short_greedy", "config": "las_small", "traffic": "short_greedy",
                               "chips": 1, "why": "short clips"})
    bench["per_layer"].append({"name": "served_batches", "unit": "batches", "better": "higher",
                               "source": "program_span", "layer": "Listener", "moves": "decode_throughput",
                               "workloads": ["las_small.short_greedy"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "las_large.decode_greedy" in m["workloads"]:
            m["workloads"].append("las_small.short_greedy")
    with open(bench_json, "w") as f:
        json.dump(bench, f)

    cell = load_cell("las_small.short_greedy", bench_json, data)
    assert "served_batches" in cell.metric_modules
    r = run.run_cell(cell, 12, 0.3, True, torch.device("cpu"), time.perf_counter())
    line = run.result_line(cell, r, True, {"platform": "cpu", "kind": "cpu", "count": 1})
    assert line["correct"] is True
    assert line["metrics"]["served_batches"]["value"] > 0
    r = run.run_cell(cell, 12, 0.3, False, torch.device("cpu"), time.perf_counter())
    line = run.result_line(cell, r, False, {"platform": "cpu", "kind": "cpu", "count": 1})
    assert {"setup_s", "decode_throughput", "peak_mem_gib"} <= set(line["metrics"])
