"""Losses and metrics (counterpart of speech_recognition_tpu/measure.py): masked
cross-entropy and accuracy over logits, and the CTC loss with its dynamic
programme in plain PyTorch (the JAX package computes it outside any Pallas
kernel).

Reductions are float32 whatever the compute type, as in JAX.  Under data
parallelism each loss is this rank's share of the global batch's: its own
numerator over the denominator summed over the ``data`` axis
(``parallel.data_sum``), so the shares add up to the loss JAX takes over the
whole batch, and so do their gradients.
"""

from typing import Tuple

import torch

from .parallel.mesh import data_sum


def sparse_categorical_crossentropy(y_true, logits, ignore_index: int = 0) -> torch.Tensor:
    """Masked sparse CE from logits, averaged over the non-pad positions
    (measure.py:14-28): logsumexp(logits) - logits[y]."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    gathered = logits.gather(-1, y_true[..., None].long())[..., 0].float()
    mask = (y_true != ignore_index).float()
    return ((lse - gathered) * mask).sum() / data_sum(mask.sum()).clamp_min(1.0)


def sparse_categorical_accuracy(y_true, logits, ignore_index: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked accuracy as (correct_sum, count) for streaming aggregation
    (measure.py:31-38).  ``argmax`` takes the first maximum on ties, as ``jnp.argmax``."""
    mask = y_true != ignore_index
    correct = torch.where(mask, (logits.argmax(dim=-1) == y_true).float(), 0.0).sum()
    return correct, mask.float().sum()


_NEG = -1e30


def _emission_logprobs(logits, ids):
    """log softmax(logits) gathered at ``ids`` [B, K] -> [B, T, K] float32
    (measure.py:44-76; autograd's gather transpose sums duplicate ids, as the
    JAX custom backward's one-hot product does)."""
    B, T, _ = logits.shape
    lse = torch.logsumexp(logits.float(), dim=-1)
    vals = logits.gather(2, ids.long()[:, None, :].expand(B, T, ids.shape[1])).float()
    return vals - lse[..., None]


def _ctc_ids(y, blank_index: int):
    """The emission columns: the labels, then the blank -> [B, N+1]."""
    return torch.cat([y, torch.full((y.shape[0], 1), blank_index, dtype=y.dtype, device=y.device)], dim=1)


def _ctc_nll_from_emission(y, emission, pad_index: int):
    """CTC forward DP over emission log-probs [B, T, N+1] (labels, then the
    blank as the last column), full padded T as every row's logit length
    (measure.py:96-142): (-log P(y), label lengths float32).  The log domain
    uses -1e30 and not -inf, so that an unreachable state keeps finite
    gradients."""
    B, T, _ = emission.shape
    N = y.shape[1]
    S = 2 * N + 1
    blank_lp = emission[..., N]
    # augmented sequence z = [blank, y1, blank, y2, ..., yN, blank]
    e_all = torch.cat([torch.stack([blank_lp[..., None].expand(B, T, N), emission[..., :N]], dim=-1).reshape(B, T, 2 * N),
                       blank_lp[..., None]], dim=-1)
    # the skip s-2 -> s is allowed at odd s >= 3 when y[k] != y[k-1]
    skip_ok = torch.zeros(B, S, dtype=torch.bool, device=y.device)
    skip_ok[:, 3::2] = y[:, 1:] != y[:, :-1]
    neg = torch.full((B, 1), _NEG, dtype=torch.float32, device=y.device)
    alpha = torch.where(torch.arange(S, device=y.device) < 2, e_all[:, 0], _NEG)
    for t in range(1, T):
        a1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        a2 = torch.where(skip_ok, torch.cat([neg, neg, alpha[:, :-2]], dim=1), _NEG)
        alpha = e_all[:, t] + torch.logaddexp(torch.logaddexp(alpha, a1), a2)
    label_lengths = (y != pad_index).sum(dim=-1)
    idx_last = torch.clamp(2 * label_lengths, 0, S - 1)[:, None]
    idx_prev = torch.clamp(2 * label_lengths - 1, 0, S - 1)[:, None]
    ll = torch.logaddexp(alpha.gather(1, idx_last)[:, 0], alpha.gather(1, idx_prev)[:, 0])
    return -ll, label_lengths.float()


def _ctc_normalize(per_seq, label_lengths):
    """Per-sequence NLL / label length, averaged over rows with a label
    (measure.py:161-164): all-pad rows are batch padding."""
    valid_row = (label_lengths > 0).float()
    per_seq = per_seq / label_lengths.clamp_min(1.0) * valid_row
    return per_seq.sum() / data_sum(valid_row.sum()).clamp_min(1.0)


def ctc_loss(y_true, logits, blank_index: int, pad_index: int = 0):
    """CTC loss of logits [B, T, V] against pad-padded labels ``y_true`` [B, N],
    normalized by label length and averaged over real rows (measure.py:145-164)."""
    y = y_true.long()
    emission = _emission_logprobs(logits, _ctc_ids(y, blank_index))
    return _ctc_normalize(*_ctc_nll_from_emission(y, emission, pad_index))


def ctc_loss_from_hidden(y_true, hid, W, b, blank_index: int, pad_index: int = 0):
    """``ctc_loss`` of ``hid @ W + b`` without the [B, T, V] logits, through the
    fused emissions (kernel K6) in bf16 and float32 (measure.py:167-186).

    :param hid: [B, T, H]; ``W`` [H, V]; ``b`` [V]; ``y_true`` [B, N]
    """
    from .ops.ctc_emissions import fused_ctc_emissions

    y = y_true.long()
    emission = fused_ctc_emissions(hid, W, b, _ctc_ids(y, blank_index))
    return _ctc_normalize(*_ctc_nll_from_emission(y, emission, pad_index))
