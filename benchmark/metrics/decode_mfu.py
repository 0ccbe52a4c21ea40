"""decode_mfu: each batch's model operations in the measured window (frontend, listener, keys, and the
speller steps the search actually ran with their vocab projections, ``benchlib.work.decode_flops``),
over the window's host seconds (untraced: the traced run measures the window first), as a share of
the H100's 989 TFLOP/s bf16 peak.  Moves ``decode_throughput``."""

from benchlib import work

SPANS = ()


def read(trace):
    c = trace.cell
    w = c.get("window")
    if c["traffic"]["kind"] != "decode" or not w or not w["items"]:
        return None
    beam = c["traffic"].get("beam_size", 0) if c["traffic"]["search"] == "beam" else 0
    flops = sum(work.decode_flops(c["config"], c["batch"], c["samples"], s, beam) for s in c["steps"][:w["items"]])
    return work.mfu_pct(flops, w["seconds"])
