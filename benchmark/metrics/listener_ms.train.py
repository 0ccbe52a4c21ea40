"""listener_ms.train: device milliseconds a training step of the operations launched inside the
listener (``models/las.py Listener``): its forward call, and its backward from the gradient of its
first output to the last gradient accumulated into its parameters.  Moves ``train_throughput``."""

SPANS = ({"label": "listener", "object": "listener"},)


def read(trace):
    fwd, bwd = trace.device_s("listener"), trace.device_s("listener.bwd")
    if fwd is None or bwd is None or not trace.items:
        return None
    return (fwd + bwd) / trace.items * 1e3
