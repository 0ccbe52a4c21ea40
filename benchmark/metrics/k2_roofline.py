"""k2_roofline: the teacher-forced decoder loop (kernel K2, ``ops/decoder_kernel.py decoder_fwd``):
the least time of its work at the H100's peaks over the device time of the operations launched
inside the call, in %.  Work as ``chip_smoke.py`` counts it: per step and row the query product,
scores, context and the cells' products; every step streams the projected keys and the listener
values, the other operands and outputs once.  Moves ``train_throughput``."""

from benchlib.spans import roofline_pct
from benchlib.work import PEAK_BYTES, PEAK_FLOPS, cell_flops, nbytes


def work(args, kwargs, result):
    emb, pk, value, kernels = args[0], args[2], args[3], args[7]
    N, B, _ = emb.shape
    S, H = pk.shape[1], pk.shape[2]
    Dv = value.shape[2]
    flops = N * (2.0 * B * (S * H + S * Dv + H * H) + cell_flops(B, kernels, H))
    return flops, nbytes(list(args), list(result)) + (N - 1) * nbytes(pk, value)


SPANS = ({"label": "k2", "function": "speech_recognition_tpu_torch.ops.decoder:decoder_fwd", "work": work},)


def read(trace):
    return roofline_pct(trace, ("k2",), PEAK_FLOPS, PEAK_BYTES)
