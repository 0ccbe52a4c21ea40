"""k10_roofline: the listener's recurrences in a decode (kernel K10, ``ops/rnn_sequence.py
rnn_sequence``, one call a layer, both directions): the least time of their work at the H100's
peaks over the device time of the operations launched inside the calls, in %.  Work as
``chip_smoke.py`` counts it: the recurrent product of the valid (step, direction, row) triples only,
and the bytes of the inputs and outputs.  Moves ``decode_throughput``."""

from benchlib.spans import roofline_pct
from benchlib.work import PEAK_BYTES, PEAK_FLOPS, nbytes

GATES = {"lstm": 4, "gru": 3, "rnn": 1}


def work(args, kwargs, result):
    rnn_type, x_proj, mask = args[0], args[1], args[2]
    G = GATES[rnn_type]
    H = x_proj.shape[-1] // G
    n_bytes = nbytes(list(args[1:]), list(result))
    # the valid triples are read once the window has closed: a count now would wait for the card
    return lambda: (2.0 * float(mask.sum()) * H * G * H, n_bytes)


SPANS = ({"label": "k10", "function": "speech_recognition_tpu_torch.ops.rnn:rnn_sequence", "work": work},)


def read(trace):
    return roofline_pct(trace, ("k10",), PEAK_FLOPS, PEAK_BYTES)
