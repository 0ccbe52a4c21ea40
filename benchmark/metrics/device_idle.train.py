"""device_idle.train: the share of the measured train window in which no operation ran on the card, in %:
one minus the device's busy seconds an item, from a stretch traced with the card's activity alone
(``torch.profiler``, CUDA activity only), over the untraced window's seconds an item.  The traced
stretch's own idle (``device.busy_s`` against ``device.window_s``) also holds the profiler's cost on the
host, which paces the launches.  Moves ``train_throughput``."""

SPANS = ()


def read(trace):
    q, w = trace.quiet or trace, trace.cell.get("window")
    if q.cell["traffic"]["kind"] != "train" or not q.ops or not q.items or not w or not w["items"]:
        return None
    return 100.0 * (1.0 - (q.busy_s() / q.items) / (w["seconds"] / w["items"]))
