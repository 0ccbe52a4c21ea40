"""Seeded LAS weights, made on the device in a few large draws.

The benchmark makes the weights; the program and the plain reference both get
them.  ``las_layout`` lists every parameter and buffer of the LAS tree (the
program's state-dict names, which the reference uses too) with its shape and
its initializer family; ``make_weights`` draws one flat uniform buffer from a
generator on the device and cuts it into the tensors, scaled per family:

- ``glorot``: input kernels ``[in, out]``, U(-l, l) with l = sqrt(6 / (in + out));
- ``recurrent``: recurrent kernels ``[H, 4H]`` with orthonormal rows, as the
  port's ``init_weights`` and Keras's ``orthogonal`` make them: the transposed
  Q of a QR of a ``[4H, H]`` normal draw, one batched draw and QR on the device
  per shape;
- ``lecun``: dense and conv weights, variance 1 / fan_in;
- ``embedding``: U(-0.05, 0.05);
- ``zeros`` / ``ones``; ``lstm_bias``: zeros with the forget gate's quarter at 1.
"""

import math

import torch

_GEN_SALT = 0x5EED  # the weights' generator is seeded apart from the traffic's


def _conv_out(n: int) -> int:
    return (n - 3) // 2 + 1


def las_layout(cfg: dict):
    """[(name, shape, family)] of the LAS tree for a configuration dict
    (``encoder_hidden_dim`` E, ``decoder_hidden_dim`` H, layers, ``vocab_size``,
    ``num_mel_bins``, ``use_delta_accelerate``)."""
    E, H, V = cfg["encoder_hidden_dim"], cfg["decoder_hidden_dim"], cfg["vocab_size"]
    C = 3 if cfg["use_delta_accelerate"] else 1
    F = cfg["num_mel_bins"]
    out = [("listener.conv1.weight", (32, C, 3, 3), "lecun"), ("listener.conv1.bias", (32,), "zeros"),
           ("listener.conv2.weight", (32, 32, 3, 3), "lecun"), ("listener.conv2.bias", (32,), "zeros")]
    in_dim = _conv_out(_conv_out(F)) * 32
    for i in range(cfg["num_encoder_layers"]):
        for d in ("forward_rnn", "backward_rnn"):
            p = f"listener.encoder_layer{i}.{d}.cell"
            out += [(f"{p}.kernel", (in_dim, 4 * E), "glorot"), (f"{p}.recurrent_kernel", (E, 4 * E), "recurrent"),
                    (f"{p}.bias", (4 * E,), "lstm_bias")]
        out += [(f"listener.projection{i}.weight", (2 * E, 2 * E), "lecun"),
                (f"listener.projection{i}.bias", (2 * E,), "zeros"),
                (f"listener.batch_normalization{i}.weight", (2 * E,), "ones"),
                (f"listener.batch_normalization{i}.bias", (2 * E,), "zeros"),
                (f"listener.batch_normalization{i}.running_mean", (2 * E,), "zeros"),
                (f"listener.batch_normalization{i}.running_var", (2 * E,), "ones")]
        in_dim = 2 * E
    for proj in ("hidden_states_proj", "cell_states_proj"):
        out += [(f"listener.{proj}.weight", (H, 2 * E), "lecun"), (f"listener.{proj}.bias", (H,), "zeros")]
    a = "attend_and_speller"
    out += [(f"{a}.embedding.weight", (V, H), "embedding"),
            (f"{a}.attention.query_weight.weight", (H, H), "lecun"), (f"{a}.attention.query_weight.bias", (H,), "zeros"),
            (f"{a}.attention.key_weight.weight", (H, 2 * E), "lecun"), (f"{a}.attention.key_weight.bias", (H,), "zeros")]
    in_dim = H + 2 * E
    for i in range(cfg["num_decoder_layers"]):
        p = f"{a}.decoder_layer{i}"
        out += [(f"{p}.kernel", (in_dim, 4 * H), "glorot"), (f"{p}.recurrent_kernel", (H, 4 * H), "recurrent"),
                (f"{p}.bias", (4 * H,), "lstm_bias")]
        in_dim = H
    out += [(f"{a}.feedforward.weight", (V, H), "lecun"), (f"{a}.feedforward.bias", (V,), "zeros")]
    return out


def _fan_in(shape, family):
    if family == "glorot":
        return shape[0]
    return math.prod(shape[1:])  # [out, in] dense, [out, in, kh, kw] conv


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``}: the seed's LAS weights (``las_layout``)."""
    layout = las_layout(cfg)
    drawn = [(n, s, f) for n, s, f in layout if f in ("glorot", "lecun", "embedding")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed((int(seed) ^ _GEN_SALT) % (2 ** 63))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)  # U(-1, 1)
    out, at = _orthogonal_rows([(n, s) for n, s, f in layout if f == "recurrent"], gen, device), 0
    for name, shape, family in layout:
        if family == "recurrent":
            continue
        if family in ("zeros", "ones", "lstm_bias"):
            t = torch.zeros(shape, device=device) if family != "ones" else torch.ones(shape, device=device)
            if family == "lstm_bias":
                H = shape[0] // 4
                t[H:2 * H] = 1.0
            out[name] = t
            continue
        n = math.prod(shape)
        if family == "glorot":
            scale = math.sqrt(6.0 / (shape[0] + shape[1]))
        elif family == "embedding":
            scale = 0.05
        else:  # variance 1 / fan_in: U(-l, l) has variance l^2 / 3
            scale = math.sqrt(3.0 / _fan_in(shape, family))
        out[name] = flat[at:at + n].view(shape).mul(scale)
        at += n
    del flat
    return out


def _orthogonal_rows(named_shapes, gen, device) -> dict:
    """{name: [H, 4H] float32 with orthonormal rows}: per shape, one normal draw [n, 4H, H] and one
    batched QR on ``device``, each kernel the transpose of its Q."""
    by_shape = {}
    for name, shape in named_shapes:
        by_shape.setdefault(tuple(shape), []).append(name)
    out = {}
    for (h, h4), names in by_shape.items():
        q, _ = torch.linalg.qr(torch.randn((len(names), h4, h), generator=gen, device=device))
        for name, k in zip(names, q.transpose(1, 2).contiguous().unbind(0)):
            out[name] = k
    return out


def n_parameters(cfg: dict) -> int:
    return sum(math.prod(s) for n, s, _ in las_layout(cfg) if not n.endswith(("running_mean", "running_var")))
