"""k11_roofline: the beam loop, steps 2..L-1 (kernel K11, ``search.py`` calling
``ops/beam_search.py beam_search``): the least time of its work at the H100's peaks over the device
time of the operations launched inside the call, in %.  Work as ``chip_smoke.py`` counts it: the
steps this call ran (the loop stops once every beam has ended), each with the query, attention,
cells and vocab products of the B*K rows; histories in and out as int32, log-probs; every step
after the first streams the projected keys and the listener values again.
Moves ``decode_throughput``."""

from benchlib.spans import roofline_pct
from benchlib.work import PEAK_BYTES, PEAK_FLOPS, cell_flops, nbytes


def work(args, kwargs, result):
    pk, value, qw, vw, cells, tokens0, logp0 = args[0], args[1], args[3], args[6], args[8], args[11], args[12]
    B, S, H = pk.shape
    K = tokens0.shape[1]
    Dv, V, R = value.shape[2], vw.shape[1], B * K
    step = 2.0 * R * (H * H + S * H + S * Dv + H * V) + cell_flops(R, [k for k, _, _ in cells], H)
    tokens, logp = result[0], result[1]
    fixed = nbytes(list(args[:11]), logp0, logp) + 4 * (tokens0.numel() + tokens.numel())

    def count():  # read once the window has closed: the steps run are in the histories
        filled = (tokens != args[14]).any(dim=0).any(dim=0).nonzero()
        n = max(int(filled.max()) - 1, 1) if len(filled) else 1
        return n * step, fixed + (n - 1) * nbytes(pk, value)

    return count


SPANS = ({"label": "k11", "function": "speech_recognition_tpu_torch.search:beam_search", "work": work},)


def read(trace):
    return roofline_pct(trace, ("k11",), PEAK_FLOPS, PEAK_BYTES)
