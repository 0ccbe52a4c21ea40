"""k4_roofline: the whole greedy decode loop (kernel K4, ``search.py`` calling
``ops/greedy_search.py greedy_search``): the least time of its work at the H100's peaks over the
device time of the operations launched inside the call, in %.  Work as ``chip_smoke.py`` counts it:
L-1 steps of attention, query, cells and vocab products for every row; every step streams the
projected keys and the listener values, the other operands and the outputs once.
Moves ``decode_throughput``."""

from benchlib.spans import roofline_pct
from benchlib.work import PEAK_BYTES, PEAK_FLOPS, cell_flops, nbytes


def work(args, kwargs, result):
    pk, value, qw, vw, cells, L = args[0], args[1], args[3], args[6], args[8], args[11]
    B, S, H = pk.shape
    Dv, V = value.shape[2], vw.shape[1]
    step = 2.0 * B * (S * H + S * Dv + H * H + H * V) + cell_flops(B, [k for k, _, _ in cells], H)
    return (L - 1) * step, nbytes(list(args[:11]), list(result)) + (L - 2) * nbytes(pk, value)


SPANS = ({"label": "k4", "function": "speech_recognition_tpu_torch.search:greedy_search", "work": work},)


def read(trace):
    return roofline_pct(trace, ("k4",), PEAK_FLOPS, PEAK_BYTES)
