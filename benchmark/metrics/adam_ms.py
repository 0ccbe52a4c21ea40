"""adam_ms: device milliseconds a step of the operations launched inside the optimizer's ``step``
(``torch.optim.Adam`` as ``train/state.py make_adam`` builds it).  Moves ``train_throughput``."""

SPANS = ({"label": "adam", "object": "optimizer"},)


def read(trace):
    dev = trace.device_s("adam")
    if dev is None or not trace.calls("adam"):
        return None
    return dev / trace.calls("adam") * 1e3
