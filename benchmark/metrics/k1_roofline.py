"""k1_roofline: the fused vocab projection + cross-entropy (kernel K1, ``ops/ce_vocab.py``
``ce_fwd`` and ``ce_bwd``), forward and backward together: the least time of their work at the
H100's peaks over the device time of the operations launched inside the calls, in %.  Work as
``chip_smoke.py`` counts it: the forward one product 2RHV, the backward three (the logits'
recompute, dhid, dW); bytes of the inputs read once and the outputs written once.
Moves ``train_throughput``."""

from benchlib.spans import roofline_pct
from benchlib.work import PEAK_BYTES, PEAK_FLOPS, nbytes


def fwd_work(args, kwargs, result):
    hid, W, b, y = args
    R, H = hid.shape
    V = W.shape[1]
    lse, lab, pred = result
    return 2.0 * R * H * V, nbytes(hid, W, b, y, lse, lab) + pred.numel() * 4


def bwd_work(args, kwargs, result):
    hid, W, b, y, lse, dnll = args
    R, H = hid.shape
    V = W.shape[1]
    return 3 * 2.0 * R * H * V, nbytes(hid, W, b, y, lse, dnll, *result)


SPANS = ({"label": "k1_fwd", "function": "speech_recognition_tpu_torch.ops.ce_vocab:ce_fwd", "work": fwd_work},
         {"label": "k1_bwd", "function": "speech_recognition_tpu_torch.ops.ce_vocab:ce_bwd", "work": bwd_work})


def read(trace):
    return roofline_pct(trace, ("k1_fwd", "k1_bwd"), PEAK_FLOPS, PEAK_BYTES)
