"""The yardstick: the card's peaks, and the work of LAS counted from its shapes.

Peaks are the published NVIDIA H100 SXM figures (dense, at the 700 W power
limit): 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3.
A roofline share is the least time the work could take, the larger of its
operations at the first and its bytes at the second, over the measured time.

Operation counts are 2 x multiply-adds of the matrix products the model
needs, from the shapes, with nothing recomputed; a backward counts two
products for each forward one.  Bytes count each input read once and each
output written once.
"""

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def nbytes(*tensors) -> int:
    """Bytes of the tensors (nested tuples and lists included, None skipped), each counted once."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif hasattr(t, "numel"):
            total += t.numel() * t.element_size()
    return total


def conv_frames(n: int) -> int:
    return (n - 3) // 2 + 1


def frames(cfg: dict, samples: int) -> int:
    return (samples - cfg["frame_length"]) // cfg["frame_step"] + 1


def frontend_flops(cfg: dict, B: int, T: int) -> float:
    """The STFT as a product with the windowed real-DFT basis and the mel product."""
    bins = cfg["fft_length"] // 2 + 1
    return 2.0 * B * T * (cfg["frame_length"] * 2 * bins + bins * cfg["num_mel_bins"])


def listener_flops(cfg: dict, B: int, T: int) -> float:
    """Forward products of the listener over T frames: the two convs, per layer both directions'
    input and recurrent products and the projection, and the state bridges."""
    E, H = cfg["encoder_hidden_dim"], cfg["decoder_hidden_dim"]
    C = 3 if cfg["use_delta_accelerate"] else 1
    F1, T1 = conv_frames(cfg["num_mel_bins"]), conv_frames(T)
    F2, T2 = conv_frames(F1), conv_frames(T1)
    flops = 2.0 * B * T1 * F1 * 32 * C * 9 + 2.0 * B * T2 * F2 * 32 * 32 * 9
    in_dim = F2 * 32
    for _ in range(cfg["num_encoder_layers"]):
        flops += 2 * 2.0 * B * T2 * (in_dim + E) * 4 * E + 2.0 * B * T2 * (2 * E) ** 2
        in_dim = 2 * E
    return flops + 2 * 2.0 * B * 2 * E * H


def step_flops(cfg: dict, R: int, S: int) -> float:
    """One speller step for R rows over S listener frames, up to the hidden state:
    query, scores, context and the cells."""
    E, H = cfg["encoder_hidden_dim"], cfg["decoder_hidden_dim"]
    Dv = 2 * E
    cells, in_dim = 0.0, H + Dv
    for _ in range(cfg["num_decoder_layers"]):
        cells += 2.0 * R * (in_dim + H) * 4 * H
        in_dim = H
    return 2.0 * R * (H * H + S * H + S * Dv) + cells


def vocab_flops(cfg: dict, R: int) -> float:
    return 2.0 * R * cfg["decoder_hidden_dim"] * cfg["vocab_size"]


def keys_flops(cfg: dict, B: int, S: int) -> float:
    return 2.0 * B * S * 2 * cfg["encoder_hidden_dim"] * cfg["decoder_hidden_dim"]


def train_step_flops(cfg: dict, B: int, samples: int, N: int) -> float:
    """Model operations of one teacher-forced training step, forward and backward (3 x forward),
    the frontend (no gradient) once."""
    T = frames(cfg, samples)
    S = conv_frames(conv_frames(T))
    fwd = listener_flops(cfg, B, T) + keys_flops(cfg, B, S) + N * (step_flops(cfg, B, S) + vocab_flops(cfg, B))
    return frontend_flops(cfg, B, T) + 3.0 * fwd


def decode_flops(cfg: dict, B: int, samples: int, steps: int, beam: int = 0) -> float:
    """Model operations of one decode: frontend, listener, keys, then ``steps`` speller steps with
    their vocab projection (greedy: B rows; beam K: the first step B rows, the others B * K)."""
    T = frames(cfg, samples)
    S = conv_frames(conv_frames(T))
    flops = frontend_flops(cfg, B, T) + listener_flops(cfg, B, T) + keys_flops(cfg, B, S)
    if beam:
        first = step_flops(cfg, B, S) + vocab_flops(cfg, B)
        return flops + first + max(steps - 1, 0) * (step_flops(cfg, B * beam, S) + vocab_flops(cfg, B * beam))
    return flops + steps * (step_flops(cfg, B, S) + vocab_flops(cfg, B))


def cell_flops(B: int, kernels, H: int) -> float:
    """One step of LSTM cells with input kernels ``kernels`` ([in, 4H] each) for B rows."""
    return sum(2.0 * B * (k.shape[0] + H) * 4 * H for k in kernels)


def mfu_pct(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / PEAK_FLOPS
