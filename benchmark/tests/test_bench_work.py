"""The benchmark's operation and byte counts against hand counts at a small shape."""

import torch

from benchlib import work


def test_nbytes():
    assert work.nbytes(torch.zeros(3, 4), [torch.zeros(2, dtype=torch.bfloat16), None], (torch.zeros(1, dtype=torch.int64),)) == 48 + 4 + 8


def test_step_and_vocab_flops_by_hand():
    cfg = {"encoder_hidden_dim": 2, "decoder_hidden_dim": 3, "num_decoder_layers": 2, "vocab_size": 10}
    # R=1, S=5: query 3*3, scores 5*3, context 5*4 (Dv = 4); cell 0 (3+4+3) x 12, cell 1 (3+3) x 12
    assert work.step_flops(cfg, 1, 5) == 2 * (9 + 15 + 20) + 2 * (10 * 12) + 2 * (6 * 12)
    assert work.vocab_flops(cfg, 2) == 2 * 2 * 3 * 10


def test_listener_flops_by_hand():
    cfg = {"encoder_hidden_dim": 2, "decoder_hidden_dim": 3, "num_encoder_layers": 1, "num_mel_bins": 7,
           "use_delta_accelerate": False}
    # T=9 frames, F=7: conv1 -> 4 x 3, conv2 -> 1 x 1; input 32, LSTM 4E = 8 gates
    conv = 2 * 4 * 3 * 32 * 1 * 9 + 2 * 1 * 1 * 32 * 32 * 9
    lstm = 2 * 2 * 1 * (32 + 2) * 8 + 2 * 1 * 4 * 4
    bridge = 2 * 2 * 4 * 3
    assert work.listener_flops(cfg, 1, 9) == conv + lstm + bridge


def test_train_flops_triple_the_forward():
    cfg = {"encoder_hidden_dim": 4, "decoder_hidden_dim": 4, "num_encoder_layers": 1, "num_decoder_layers": 1,
           "num_mel_bins": 20, "use_delta_accelerate": True, "vocab_size": 16, "frame_length": 320,
           "frame_step": 160, "fft_length": 320}
    samples = 63 * 160 + 320
    T, S = 64, 15
    fwd = work.listener_flops(cfg, 2, T) + work.keys_flops(cfg, 2, S) + 5 * (work.step_flops(cfg, 2, S)
                                                                             + work.vocab_flops(cfg, 2))
    assert work.train_step_flops(cfg, 2, samples, 5) == work.frontend_flops(cfg, 2, T) + 3 * fwd


def test_roofline_metric_counts():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics", "k2_roofline.py")
    spec = importlib.util.spec_from_file_location("k2", path)
    k2 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k2)
    N, B, S, H, Dv = 3, 2, 5, 4, 6
    t = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    args = (t(N, B, H), t(N, B, 1), t(B, S, H), t(B, S, Dv), t(B, S), t(H, H), t(H), [t(H + Dv, 4 * H)],
            [t(H, 4 * H)], [t(4 * H)], [t(B, H + Dv)], t(B, H), t(B, H), t(B, H))
    result = ((t(B, H), t(B, H)), (t(N, B, H),))
    flops, n_bytes = k2.work(args, {}, result)
    assert flops == N * (2 * B * (S * H + S * Dv + H * H) + 2 * B * (H + Dv + H) * 4 * H)
    every = 2 * sum(a.numel() for a in args if not isinstance(a, list)) + 2 * sum(x.numel() for a in args if isinstance(a, list) for x in a)
    assert n_bytes == every + 2 * (2 * B * H + N * B * H) + (N - 1) * 2 * (B * S * H + B * S * Dv)
