"""Mixture-of-experts FFN for DeepSpeech2's trunk (counterpart of
speech_recognition_tpu/models/moe.py and the single-device part of
speech_recognition_tpu/parallel/expert.py).

``MoELayer`` is a residual Switch-routed FFN, ``x + MoE(x)``, with Flax's
parameter names and layouts (``router [d, E]``, ``w_in [E, d, H]``, ``b_in
[E, H]``, ``w_out [E, H, d]``, ``b_out [E, d]``), so the weight bridge copies
them unchanged.  The routing semantics are JAX's ``_route``:

- router logits are float32 products of the input cast to float32 (callers
  keep TF32 off); softmax, then the top-k experts with ties to the lower
  index (``lax.top_k``'s order); with k = 2 the kept gates are renormalised;
- capacity ``C = max(1, ceil(N k capacity_factor / E))`` over the N flattened
  tokens (row-major over [B, T']: b * T' + t); slot 0 fills before slot 1, and
  within a slot ranks follow token order; a token past its expert's capacity
  is dropped (zero output, the residual kept);
- pad tokens (``mask`` False) never dispatch, use no capacity and are left out
  of the load-balancing statistics;
- aux = E * sum_e f_e * P_e (f_e: the share of tokens whose first choice is
  e, P_e: the mean router probability), scaled by ``aux_weight``; the train
  step adds it to the loss (``train/state.py``);
- dispatch keeps the input dtype, the expert FFN runs in the compute dtype,
  the combine weights are float32 cast to the expert output's dtype.

JAX writes dispatch and combine as one-hot [N, E, C] einsums
(``moe_ffn_einsum``, kept as the plain version the tests hold the other
against); at DeepSpeech2's training shape that is 239 M entries per tensor
and layer.  ``moe_ffn`` computes the same function with indices: each kept
(token, slot) owns one buffer row, so a gather of the token rows into
[E, C, D] buffers, two batched products and a gather of the expert outputs
times the gate give the same values.
"""

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def one_hot(i: torch.Tensor, n: int) -> torch.Tensor:
    """[...] int -> [..., n] int64 (no host sync on the card, unlike ``F.one_hot``'s range check)."""
    return (i[..., None] == torch.arange(n, device=i.device)).long()


def capacity(n_tokens: int, n_experts: int, k: int, capacity_factor: float) -> int:
    return max(1, int(np.ceil(n_tokens * k * capacity_factor / n_experts)))


def route(params: Dict[str, torch.Tensor], x: torch.Tensor, k: int, cap: int, mask: Optional[torch.Tensor] = None):
    """Top-k routing with per-expert capacity for tokens ``x`` [n, D].

    Returns ``(experts [n, k] int64, slots [n, k] int64 (the rank at the expert,
    valid where kept), kept [n, k] bool, gates [n, k] float32, aux)``."""
    E = params["router"].shape[-1]
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)  # [n, E]
    # top-k as repeated argmax: ties go to the lower expert index, as lax.top_k's
    left, idx = probs.detach(), []
    for s in range(k):
        idx.append(torch.argmax(left, dim=-1))
        if s + 1 < k:
            left = left.scatter(1, idx[-1][:, None], float("-inf"))
    idx = torch.stack(idx, dim=1)  # [n, k]
    gates = torch.gather(probs, 1, idx)
    if k > 1:
        gates = gates / gates.sum(-1, keepdim=True)
    valid = None if mask is None else mask.reshape(-1).long()
    counts = torch.zeros(E, dtype=torch.long, device=x.device)
    slots, kept = [], []
    for s in range(k):
        m = one_hot(idx[:, s], E)  # [n, E]
        if valid is not None:
            m = m * valid[:, None]
        # rank within the expert, in token order: the scan runs along the inner axis of [E, n]
        pos = torch.cumsum(m.t().contiguous(), dim=1).t() - 1 + counts[None, :]
        counts = counts + m.sum(0)
        pos_tok = (pos * m).sum(-1)
        slots.append(pos_tok)
        kept.append((pos_tok < cap) & (m.sum(-1) > 0))
    top1 = one_hot(idx[:, 0], E).float()
    if valid is None:
        f, p = top1.mean(0), probs.mean(0)
    else:
        denom = torch.clamp(valid.sum().float(), min=1.0)
        f = (top1 * valid[:, None]).sum(0) / denom
        p = (probs * valid[:, None]).sum(0) / denom
    aux = E * (f * p).sum()
    return idx, torch.stack(slots, dim=1), torch.stack(kept, dim=1), gates, aux


def expert_ffn(params: Dict[str, torch.Tensor], buf: torch.Tensor) -> torch.Tensor:
    """Per-expert FFN over dispatch buffers [E, C, D] -> [E, C, D], in the buffers' dtype."""
    dt = buf.dtype
    h = torch.relu(torch.bmm(buf, params["w_in"].to(dt)) + params["b_in"][:, None, :].to(dt))
    return torch.bmm(h, params["w_out"].to(dt)) + params["b_out"][:, None, :].to(dt)


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor, k: int = 1, capacity_factor: float = 1.25,
            cap: Optional[int] = None, mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed FFN, index form: ``x`` [..., D] -> (y [..., D], aux).  Dropped and pad
    tokens get zero output (add the residual outside)."""
    lead, D = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, D)
    n, E = xt.shape[0], params["router"].shape[-1]
    cap = capacity(n, E, k, capacity_factor) if cap is None else cap
    idx, slots, kept, gates, aux = route(params, xt, k, cap, mask)
    # buffer row of each (token, slot); dropped ones point at a spare zero row past the buffers
    rows = torch.where(kept, idx * cap + slots, E * cap)  # [n, k]
    token_of_row = torch.full((E * cap + 1,), n, dtype=torch.long, device=x.device)
    token_of_row.scatter_(0, rows.reshape(-1), torch.arange(n, device=x.device).repeat_interleave(k))
    # index_select, not advanced indexing: its backward adds into the rows, where advanced indexing's
    # sorts the indices and walks the spare row's many repeats one by one
    x_pad = torch.cat([xt, xt.new_zeros(1, D)])
    buf = x_pad.index_select(0, token_of_row[: E * cap]).view(E, cap, D)
    y = expert_ffn(params, buf)  # [E, C, D]
    y_pad = torch.cat([y.reshape(E * cap, D), y.new_zeros(1, D)])
    picked = y_pad.index_select(0, rows.reshape(-1)).view(n, k, D)
    # float32 sums of the gate-weighted rows (each weight rounded to y's dtype first), one rounding to y's dtype
    out = (picked.float() * gates.to(y.dtype).float()[..., None]).sum(1).to(y.dtype)
    return out.reshape(*lead, D), aux


def moe_ffn_einsum(params: Dict[str, torch.Tensor], x: torch.Tensor, k: int = 1, capacity_factor: float = 1.25,
                   cap: Optional[int] = None, mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function with JAX's one-hot [N, E, C] dispatch and combine (``moe_ffn``'s plain version)."""
    lead, D = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, D)
    n, E = xt.shape[0], params["router"].shape[-1]
    cap = capacity(n, E, k, capacity_factor) if cap is None else cap
    idx, slots, kept, gates, aux = route(params, xt, k, cap, mask)
    dispatch = torch.zeros(n, E, cap, dtype=x.dtype, device=x.device)
    combine = torch.zeros(n, E, cap, dtype=torch.float32, device=x.device)
    for s in range(k):
        hot = (one_hot(idx[:, s], E).bool()[:, :, None] & one_hot(slots[:, s], cap).bool()[:, None, :]
               & kept[:, s, None, None])  # a slot past the capacity matches no column, as jax.nn.one_hot's
        dispatch = dispatch + hot.to(x.dtype)
        combine = combine + gates[:, s, None, None] * hot
    buf = torch.einsum("nd,nec->ecd", xt, dispatch)
    y = expert_ffn(params, buf)
    out = torch.einsum("ecd,nec->nd", y, combine.to(y.dtype))
    return out.reshape(*lead, D), aux


class MoELayer(nn.Module):
    """Residual routed FFN ``x + MoE(x)`` (JAX ``MoELayer``, moe.py:22-69) on one device.

    ``forward(x, mask, dtype)`` -> (out, aux_weight * aux)."""

    def __init__(self, dim: int, n_experts: int, hidden_dim: int, k: int = 1, capacity_factor: float = 1.25,
                 aux_weight: float = 1e-2):
        super().__init__()
        self.k, self.capacity_factor, self.aux_weight = k, capacity_factor, aux_weight
        self.router = nn.Parameter(torch.zeros(dim, n_experts))
        self.w_in = nn.Parameter(torch.zeros(n_experts, dim, hidden_dim))
        self.b_in = nn.Parameter(torch.zeros(n_experts, hidden_dim))
        self.w_out = nn.Parameter(torch.zeros(n_experts, hidden_dim, dim))
        self.b_out = nn.Parameter(torch.zeros(n_experts, dim))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initializers: N(0, 1/d) router and w_in, N(0, 1/H) w_out, zero biases."""
        d, H = self.w_in.shape[1], self.w_in.shape[2]
        for p, std in ((self.router, 1.0 / math.sqrt(d)), (self.w_in, 1.0 / math.sqrt(d)),
                       (self.w_out, 1.0 / math.sqrt(H))):
            p.copy_(torch.randn(p.shape, generator=generator) * std)
        self.b_in.zero_()
        self.b_out.zero_()

    def params(self) -> Dict[str, torch.Tensor]:
        return {"router": self.router, "w_in": self.w_in, "b_in": self.b_in, "w_out": self.w_out, "b_out": self.b_out}

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], dtype: torch.dtype):
        y, aux = moe_ffn(self.params(), x.to(dtype), self.k, self.capacity_factor, mask=mask)
        return x + y.to(x.dtype), self.aux_weight * aux
