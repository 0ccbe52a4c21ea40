"""k3_roofline: the reverse decoder loop (kernel K3, ``ops/decoder_kernel.py decoder_bwd``): the
least time of its work at the H100's peaks over the device time of the operations launched inside
the call, in %.  Work as ``chip_smoke.py`` counts it: per step and row the attention's VJP (the
query product, scores, context) and the cells' products; every step streams the projected keys and
the listener values, the step's probabilities and the rest once.  Moves ``train_throughput``."""

from benchlib.spans import roofline_pct
from benchlib.work import PEAK_BYTES, PEAK_FLOPS, cell_flops, nbytes


def work(args, kwargs, result):
    dhidden, pk, value, kernels = args[0], args[6], args[7], args[9]
    N, B, H = dhidden.shape
    S, Dv = pk.shape[1], value.shape[2]
    flops = N * (2.0 * B * (S * H + S * Dv + H * H) + cell_flops(B, kernels, H))
    return flops, nbytes(list(args[:-1]), list(result)) + (N - 1) * nbytes(pk, value)


SPANS = ({"label": "k3", "function": "speech_recognition_tpu_torch.ops.decoder:decoder_bwd", "work": work},)


def read(trace):
    return roofline_pct(trace, ("k3",), PEAK_FLOPS, PEAK_BYTES)
