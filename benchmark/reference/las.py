"""Plain PyTorch reference of Listen, Attend and Spell (Chan et al., arXiv:1508.01211) as the shipped
configurations define it, for the benchmark's comparisons.

It imports only ``torch``, ``numpy`` and ``math``: nothing of the program.  It
computes in float32 with TF32 off (``mode="fp32"``), or, as the benchmark's
control, with every matrix product in float8 e4m3 (``mode="fp8"``; ``"int8"``
and ``"bf16"`` for readings beside it): each
operand rounded with a per-tensor scale, weights and the attention's keys and
values once a forward, the other operand at each product, and in the
backward the incoming gradient before each product; the convolutions' inputs
and weights are rounded in the forward only.  Weights are the benchmark's tensor dict
(``benchlib/weights.py``), the same the program is given.

- Frontend: tf.signal conventions: frames of ``frame_length`` every
  ``frame_step`` samples (no end padding), a periodic Hann window, the rFFT's
  power, an HTK mel filterbank (DC bin zeroed), ``log(x + 1e-12)``; frames
  past a clip's last whole frame are zero; delta and delta-delta channels
  (differences with the frame before, zero before the first), masked again.
- Listener: two 3x3 stride-2 VALID convolutions (dropout after each), then
  per layer a masked bidirectional LSTM (Keras gates i, f, g, o; a masked step
  keeps its state and emits zeros; one input-dropout mask ``[B, 1, D]`` per
  direction; each direction starts from the previous layer's final state in
  that direction, the first from zeros), a dense projection, batch norm (batch statistics over every
  frame in training, epsilon 1e-3; running statistics otherwise) and ReLU.
  The valid length after the convolutions is ``ceil(frames / 4)``.  The
  speller starts from dense projections of [forward h, backward h] and
  [forward c, backward c].
- Speller: per step, dot-product attention of ``q = W_q h + b_q`` over the
  projected listener outputs (padded frames at -1e9), the context beside the
  embedded previous token, then the LSTM cells with ONE (h, c) threaded
  through them in turn; a pad token keeps the state and emits zeros.
  Training dropout: masks for the embedding, the output and each cell's
  input, fixed over the steps.
- Dropout masks are ``torch.rand(shape) < 1 - rate`` drawn in the order the
  layers consume them (conv1, conv2, each listener layer's forward then
  backward direction, then the speller's embedding, output and cells), so a
  generator seeded as the program's gives the program's masks.
- Loss: the mean cross-entropy over the non-pad labels.  Adam: b1 0.9,
  b2 0.999, epsilon 1e-7 outside the root, bias-corrected.
- Search: greedy logit gaps along served tokens, and the beam search with
  the length penalty ``((1 + len) / (1 + beta))^alpha`` whose decoder states
  stay in their slots while the histories are re-gathered by parent.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale (its largest magnitude at 448)."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _int8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to int8 with a per-tensor scale (its largest magnitude at 127)."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 127.0
    return torch.round(x.detach() / scale).clamp(-127, 127) * scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (a witness: the configurations' own precision, products alone)."""
    return x.detach().to(torch.bfloat16).to(torch.float32)


ROUNDING = {"fp8": _fp8, "int8": _int8, "bf16": _bf16}


class _RoundedOperand(torch.autograd.Function):
    """An operand used by many products (a weight, the listener's keys and values), rounded once;
    its gradient passes straight through to the float32 tensor."""

    @staticmethod
    def forward(ctx, x, rnd):
        return rnd(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _LowProduct(torch.autograd.Function):
    """``a @ b`` with ``a`` rounded here, ``b`` already rounded, and the incoming gradient rounded
    before each of the backward's two products."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        a8 = rnd(a)
        ctx.save_for_backward(a8, b)
        ctx.rnd = rnd
        return a8 @ b

    @staticmethod
    def backward(ctx, g):
        a8, b = ctx.saved_tensors
        g8 = ctx.rnd(g)
        ga = g8 @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = a8.transpose(-1, -2) @ g8 if ctx.needs_input_grad[1] else None
        return ga, gb, None


def hann(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def mel_matrix(num_mel: int, num_bins: int, sample_rate: float, lo: float, hi: float) -> np.ndarray:
    """[num_bins, num_mel] triangular HTK mel filters over the rFFT bins, the DC bin's row zero."""
    to_mel = lambda f: 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)
    bins_mel = to_mel(np.linspace(0.0, sample_rate / 2.0, num_bins)[1:])[:, None]
    edges = np.linspace(to_mel(lo), to_mel(hi), num_mel + 2)
    lower, center, upper = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
    w = np.maximum(0.0, np.minimum((bins_mel - lower) / (center - lower), (upper - bins_mel) / (upper - center)))
    return np.concatenate([np.zeros((1, num_mel)), w], axis=0)


class Drops:
    """Dropout masks from ``generator`` in draw order; ``rate`` 0 draws nothing."""

    def __init__(self, generator, rate: float):
        self.generator, self.rate = generator, rate

    def keep(self, shape, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=device) < 1.0 - self.rate

    def scale(self, shape, device) -> torch.Tensor:
        return self.keep(shape, device).float() / (1.0 - self.rate)


class LASReference:
    def __init__(self, cfg: dict, weights: dict, mode: str = "fp32", requires_grad: bool = False):
        if mode != "fp32" and mode not in ROUNDING:
            raise ValueError(f"mode {mode}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.mode = cfg, mode
        self.p = {k: v.detach().float().clone().requires_grad_(requires_grad and not k.endswith(("running_mean",
                                                                                                    "running_var")))
                  for k, v in weights.items()}
        self.E, self.H = cfg["encoder_hidden_dim"], cfg["decoder_hidden_dim"]
        self._w = {}

    # -- products
    def begin(self):
        """A new forward: weights are rounded again (training moves them)."""
        self._w = {}

    def prep(self, x):
        """An operand that many products share, rounded once in fp8 mode."""
        return _RoundedOperand.apply(x, ROUNDING[self.mode]) if self.mode != "fp32" else x

    def w(self, name, t=False):
        key = (name, t)
        if key not in self._w:
            self._w[key] = self.prep(self.p[name].t() if t else self.p[name])
        return self._w[key]

    def mm(self, a, b):
        """``a @ b`` for ``b`` from ``prep`` / ``w``."""
        if self.mode == "fp32":
            return a @ b
        rnd = ROUNDING[self.mode]
        if b.dim() == 2:
            return _LowProduct.apply(a.reshape(-1, a.shape[-1]), b, rnd).reshape(*a.shape[:-1], b.shape[-1])
        return _LowProduct.apply(a, b, rnd)

    def linear(self, x, name):
        return self.mm(x, self.w(f"{name}.weight", t=True)) + self.p[f"{name}.bias"]

    def params(self):
        return {k: v for k, v in self.p.items() if v.requires_grad}

    # -- frontend
    def frontend(self, audio: torch.Tensor, lengths: torch.Tensor):
        """(feats [B, T, F, 3] float32, frames [B] valid frames)."""
        c = self.cfg
        fl, fs, n_fft = c["frame_length"], c["frame_step"], c["fft_length"]
        frames = audio.float().unfold(-1, fl, fs)  # [B, T, fl]
        window = torch.from_numpy(hann(fl)).float().to(audio.device)
        power = torch.fft.rfft(frames * window, n=n_fft).abs() ** 2
        mel = torch.from_numpy(mel_matrix(c["num_mel_bins"], n_fft // 2 + 1, c["sample_rate"], c["lower_edge_hertz"],
                                          c["upper_edge_hertz"])).float().to(audio.device)
        feats = torch.log(self.mm(power, self.prep(mel)) + 1e-12)[..., None]
        valid = torch.clamp((lengths.long() - fl) // fs + 1, min=0)
        keep = (torch.arange(feats.shape[1], device=audio.device)[None, :] < valid[:, None])[:, :, None, None]
        feats = feats * keep
        if c["use_delta_accelerate"]:
            prev = lambda x: F.pad(x, (0, 0, 0, 0, 1, 0))[:, :-1]
            delta = feats - prev(feats)
            feats = torch.cat([feats, delta, delta - prev(delta)], dim=-1) * keep
        return feats, valid

    # -- listener
    def _bilstm(self, x, mask, layer: int, drops, init):
        """x [B, T, D], mask [B, T], the initial (h_f, c_f, h_b, c_b) or None
        -> (out [B, T, 2E], (h_f, c_f, h_b, c_b))."""
        B, T, D = x.shape
        E = self.E
        outs, finals = [], []
        for d, name in enumerate(("forward_rnn", "backward_rnn")):
            p = f"listener.encoder_layer{layer}.{name}.cell"
            xd = x * drops.scale((B, 1, D), x.device) if drops is not None else x
            xp = self.mm(xd, self.w(f"{p}.kernel")) + self.p[f"{p}.bias"]
            rk = self.w(f"{p}.recurrent_kernel")
            h, c = (x.new_zeros(B, E), x.new_zeros(B, E)) if init is None else init[2 * d:2 * d + 2]
            out = [None] * T
            steps = range(T) if d == 0 else range(T - 1, -1, -1)
            for t in steps:
                z = xp[:, t] + self.mm(h, rk)
                h_new, c_new = _lstm(z, c)
                m = mask[:, t, None]
                h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
                out[t] = h_new * m
            outs.append(torch.stack(out, dim=1))
            finals += [h, c]
        return torch.cat(outs, dim=-1), finals

    def listener(self, feats, frames, training: bool, drops=None):
        """feats [B, T, F, C] -> (value [B, T', 2E], mask [B, T'], (h, c) [B, H])."""
        x = feats.permute(0, 3, 1, 2)
        for conv in ("conv1", "conv2"):
            w, b = self.p[f"listener.{conv}.weight"], self.p[f"listener.{conv}.bias"]
            x = F.conv2d(self.prep(x), self.prep(w), b, stride=2)
            if drops is not None:
                x = torch.where(drops.keep(x.shape, x.device), x / (1.0 - drops.rate), torch.zeros((), device=x.device))
        B, _, T2, _ = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, T2, -1)
        lengths = torch.clamp((frames.long() + 3) // 4, max=T2)
        mask = torch.arange(T2, device=x.device)[None, :] < lengths[:, None]
        states = None
        for i in range(self.cfg["num_encoder_layers"]):
            x, states = self._bilstm(x, mask, i, drops, states)
            hf, cf, hb, cb = states
            x = self.linear(x, f"listener.projection{i}")
            bn = f"listener.batch_normalization{i}"
            if training:
                mean = x.mean(dim=(0, 1))
                var = torch.clamp((x * x).mean(dim=(0, 1)) - mean * mean, min=0.0)
            else:
                mean, var = self.p[f"{bn}.running_mean"], self.p[f"{bn}.running_var"]
            x = torch.relu((x - mean) * torch.rsqrt(var + 1e-3) * self.p[f"{bn}.weight"] + self.p[f"{bn}.bias"])
        h = self.linear(torch.cat([hf, hb], dim=-1), "listener.hidden_states_proj")
        c = self.linear(torch.cat([cf, cb], dim=-1), "listener.cell_states_proj")
        return x, mask, (h, c)

    # -- speller
    def keys(self, value):
        return self.linear(value, "attend_and_speller.attention.key_weight")

    def attention_operands(self, value, keys):
        """(keys^T [B, H, S], values [B, S, Dv]) as every step's products take them."""
        return self.prep(keys.transpose(1, 2)), self.prep(value)

    def step(self, operands, mask, tok, state, masks=None):
        """One speller step over ``attention_operands``: (hidden [B, H] before the vocab projection,
        new (h, c))."""
        a = "attend_and_speller"
        keys_t, value = operands
        h, c = state
        q = self.linear(h, f"{a}.attention.query_weight")
        scores = self.mm(q[:, None, :], keys_t)[:, 0] - 1e9 * (~mask).float()
        ctx = self.mm(torch.softmax(scores, dim=-1)[:, None, :], value)[:, 0]
        x = self.p[f"{a}.embedding.weight"][tok]
        if masks is not None:
            x = x * masks["emb"]
        x = torch.cat([x, ctx], dim=-1)
        m = (tok != self.cfg["pad_id"])[:, None]
        for i in range(self.cfg["num_decoder_layers"]):
            p = f"{a}.decoder_layer{i}"
            if masks is not None:
                x = x * masks["cells"][i]
            z = self.mm(x, self.w(f"{p}.kernel")) + self.p[f"{p}.bias"] + self.mm(h, self.w(f"{p}.recurrent_kernel"))
            h_new, c_new = _lstm(z, c)
            h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
            x = h_new * m
        if masks is not None:
            x = x * masks["out"]
        return x, (h, c)

    def logits(self, hidden):
        return self.linear(hidden, "attend_and_speller.feedforward")

    def speller_masks(self, drops, B, device):
        H, Dv = self.H, 2 * self.E
        masks = {"emb": drops.scale((B, H), device), "out": drops.scale((B, H), device), "cells": []}
        in_dim = H + Dv
        for _ in range(self.cfg["num_decoder_layers"]):
            masks["cells"].append(drops.scale((B, in_dim), device))
            in_dim = H
        return masks

    # -- training
    def loss(self, audio, lengths, tokens, drops=None):
        """Teacher-forced mean CE of one batch: decoder input tokens[:, :-1], labels tokens[:, 1:]."""
        self.begin()
        feats, frames = self.frontend(audio, lengths)
        value, mask, state = self.listener(feats, frames, True, drops)
        operands = self.attention_operands(value, self.keys(value))
        masks = self.speller_masks(drops, tokens.shape[0], audio.device) if drops is not None else None
        dec_in, labels = tokens[:, :-1], tokens[:, 1:]
        total = value.new_zeros(())
        for t in range(dec_in.shape[1]):
            hidden, state = self.step(operands, mask, dec_in[:, t], state, masks)
            logits = self.logits(hidden)
            nll = torch.logsumexp(logits, dim=-1) - logits.gather(1, labels[:, t, None])[:, 0]
            total = total + (nll * (labels[:, t] != self.cfg["pad_id"]).float()).sum()
        return total / (labels != self.cfg["pad_id"]).float().sum().clamp_min(1.0)


def _lstm(z, c):
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
    return torch.sigmoid(zo) * torch.tanh(c_new), c_new


class Adam:
    """Adam over a dict of tensors: b1 0.9, b2 0.999, eps 1e-7 outside the root, bias-corrected."""

    def __init__(self, params: dict, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            m_hat = self.m[k] / (1.0 - 0.9 ** self.t)
            v_hat = self.v[k] / (1.0 - 0.999 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + 1e-7))


def train_steps(ref: LASReference, batches, lr: float, drop_generator, rate: float):
    """Train ``ref`` (made with ``requires_grad``) on ``batches`` [(audio, lengths, tokens)]:
    (losses, first step's gradient per leaf, change of each leaf after the last step)."""
    params = ref.params()
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for audio, lengths, tokens in batches:
        drops = Drops(drop_generator, rate) if rate > 0 else None
        loss = ref.loss(audio, lengths, tokens, drops)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        del loss, grads
    change = {k: (params[k].detach() - start[k]) for k in params}
    return losses, first, change


@torch.no_grad()
def greedy_logits(ref: LASReference, audio, lengths, served, bos_id: int, eos_id: int):
    """Logits [B, n, V] at the served tokens' positions 1..n, fed BOS then the served tokens
    (``served`` [B, L] with BOS at 0), and the number of positions that each row served up to
    and including its EOS ([B])."""
    ref.begin()
    feats, frames = ref.frontend(audio, lengths)
    value, mask, state = ref.listener(feats, frames, False)
    operands = ref.attention_operands(value, ref.keys(value))
    L = served.shape[1]
    is_eos = served[:, 1:] == eos_id
    n_pos = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1, L - 1)
    out = []
    prev = torch.full_like(served[:, 0], bos_id)
    for t in range(1, int(n_pos.max()) + 1):
        hidden, state = ref.step(operands, mask, prev, state)
        out.append(ref.logits(hidden))
        prev = served[:, t]
    return torch.stack(out, dim=1), n_pos


@torch.no_grad()
def beam_search(ref: LASReference, audio, lengths, K: int, L: int, bos_id: int, eos_id: int, alpha: float = 1.0,
                beta: float = 32.0):
    """Beam search over the listener's output: (tokens [B, K, L], logP [B, K], lengths [B, K]),
    the beams in descending score order.  The first step from BOS seeds the K beams with the top-K
    tokens; each later step scores the K x K (parent, token) candidates, a finished parent adding
    0 once, with ``logP x ((1 + len) / (1 + beta))^alpha``, takes the top K (ties to the lower
    parent-major index) and re-gathers histories, logP and finished flags by parent, while each
    slot's decoder state runs on from the token its slot held.  It stops when every beam has
    ended, or at L - 1 tokens."""
    pad = ref.cfg["pad_id"]
    ref.begin()
    feats, frames = ref.frontend(audio, lengths)
    value, mask, state = ref.listener(feats, frames, False)
    keys = ref.keys(value)
    B = value.shape[0]
    dev = value.device
    hidden, state = ref.step(ref.attention_operands(value, keys), mask,
                             torch.full((B,), bos_id, dtype=torch.long, device=dev), state)
    lp = torch.log_softmax(ref.logits(hidden), dim=-1)
    top_lp, top_tok = _topk(lp, K)
    tokens = torch.full((B, K, L), pad, dtype=torch.long, device=dev)
    tokens[:, :, 0], tokens[:, :, 1] = bos_id, top_tok
    logp = top_lp
    ended = top_tok == eos_id
    eoslen = torch.where(ended, 2.0, 0.0)
    rep = lambda t: t.repeat_interleave(K, dim=0)
    operands_k, mask_k = ref.attention_operands(rep(value), rep(keys)), rep(mask)
    state = tuple(rep(s) for s in state)  # [B*K, H], slot-major per row
    for step in range(2, L):
        if bool(ended.all()):
            break
        prev = tokens[:, :, step - 1].reshape(B * K)
        hidden, state = ref.step(operands_k, mask_k, prev, state)
        lp = torch.log_softmax(ref.logits(hidden), dim=-1)
        top_lp, top_tok = _topk(lp, K)  # [B*K, K]
        step_lp = torch.where(ended[:, :, None], 0.0, top_lp.reshape(B, K, K))
        cand = (logp[:, :, None] + step_lp).reshape(B, K * K)
        length = torch.where(ended, eoslen, float(step + 1))
        score = cand * (((1.0 + length) / (1.0 + beta)) ** alpha).repeat_interleave(K, dim=1)
        sel = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :K]
        parent = sel // K
        p_ended = ended.gather(1, parent)
        tok = torch.where(p_ended, pad, top_tok.reshape(B, K * K).gather(1, sel))
        tokens = tokens.gather(1, parent[:, :, None].expand(B, K, L)).clone()
        tokens[:, :, step] = tok
        logp = cand.gather(1, sel)
        eoslen = torch.where(p_ended, eoslen.gather(1, parent), torch.where(tok == eos_id, float(step + 1), 0.0))
        ended = p_ended | (tok == eos_id)
    is_eos = tokens == eos_id
    lens = torch.where(is_eos.any(dim=-1), is_eos.int().argmax(dim=-1) + 1, L)
    return tokens, logp, lens


def _topk(x, k):
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, idx), idx
