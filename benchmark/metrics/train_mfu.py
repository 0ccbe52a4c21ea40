"""train_mfu: the training step's model operations (forward and backward, nothing recomputed, counted
from the shapes by ``benchlib.work.train_step_flops``) x the measured window's steps, over its host
seconds (untraced: the traced run measures the window first), as a share of the H100's 989 TFLOP/s
bf16 peak.  Moves ``train_throughput``."""

from benchlib import work

SPANS = ()


def read(trace):
    c = trace.cell
    w = c.get("window")
    if c["traffic"]["kind"] != "train" or not w or not w["items"]:
        return None
    flops = work.train_step_flops(c["config"], c["batch"], c["samples"], c["N"]) * w["items"]
    return work.mfu_pct(flops, w["seconds"])
