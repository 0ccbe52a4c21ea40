"""frontend_ms.decode: device milliseconds a batch of the operations launched inside the on-device
frontend's call (``ops/frontend.py make_batch_frontend``: framing, the STFT and mel products, log,
delta-accelerate, the pad masks).  Moves ``decode_throughput``."""

SPANS = ({"label": "frontend", "object": "frontend"},)


def read(trace):
    dev = trace.device_s("frontend")
    if dev is None or not trace.calls("frontend"):
        return None
    return dev / trace.calls("frontend") * 1e3
