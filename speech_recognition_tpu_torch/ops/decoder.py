"""Custom-gradient teacher-forced LAS decoder loop (counterpart of speech_recognition_tpu/ops/decoder.py).

``decoder_scan_lstm`` runs the N teacher-forced decoder steps (attention +
the threaded LSTM cell stack) as a ``torch.autograd.Function`` with the JAX
custom VJP's operands and its minimal residuals:

- forward: kernel K2 (``ops/decoder_kernel.decoder_fwd``) emits the hidden
  stream plus h_start, c_in0 and each cell's z and c';
- backward: the query / scores / probs trajectory is recomputed outside the
  loop as batched products (ops/decoder.py:158-160), kernel K3 runs the
  reverse loop and emits dz per cell and the attention-side streams, and
  every weight gradient is one product over the saved trajectories after
  the loop (``_decoder_bwd_tail``, ops/decoder.py:253-297).  The recompute
  and the tail are large products that the JAX package leaves to XLA; here
  they are ``torch.einsum``.

Gradients of the dropout masks and the token mask are zeros, as in JAX.
"""

import torch

from .decoder_kernel import decoder_bwd, decoder_fwd


def _decoder_bwd_tail(emb, token_mask, pk, value, cell_masks, h_start, zs, c_ps, q, probs, dzs, dctx, dscores, dq):
    """Weight gradients, each one product over the per-step streams:
    (dkernels, drkernels, dbiases, dqw, dqb, dpk, dvalue, dattn_bias)."""
    He = emb.shape[-1]
    H = h_start.shape[-1]
    dz0 = dzs[0]
    ctx = torch.einsum("nbs,bsd->nbd", probs, value)
    cm0 = cell_masks[0]
    dkernels = [torch.cat([torch.einsum("nbx,nbz->xz", emb * cm0[None, :, :He], dz0),
                           torch.einsum("nbd,nbz->dz", ctx * cm0[None, :, He:], dz0)], dim=0)]
    drkernels = [torch.einsum("nbh,nbz->hz", h_start, dz0)]
    h_rec = h_start
    for i in range(1, len(dzs)):
        h_p_prev = torch.sigmoid(zs[i - 1][..., 3 * H:]) * torch.tanh(c_ps[i - 1])
        x_i = h_p_prev * token_mask
        h_rec = token_mask * h_p_prev + (1.0 - token_mask) * h_rec
        dkernels.append(torch.einsum("nbh,nbz->hz", x_i * cell_masks[i][None], dzs[i]))
        drkernels.append(torch.einsum("nbh,nbz->hz", h_rec, dzs[i]))
    dbiases = [dz.sum(dim=(0, 1)) for dz in dzs]
    dqw = torch.einsum("nbh,nbq->hq", h_start, dq)
    dqb = dq.sum(dim=(0, 1))
    dpk = torch.einsum("nbs,nbh->bsh", dscores, q)
    dvalue = torch.einsum("nbs,nbd->bsd", probs, dctx)
    dattn_bias = dscores.sum(dim=0)
    return dkernels, drkernels, dbiases, dqw, dqb, dpk, dvalue, dattn_bias


class _DecoderScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n_cells, emb, token_mask, pk, value, attn_bias, qw, qb, out_mask, h0, c0, *cell_ops):
        emb, token_mask, pk, value, attn_bias, qw, qb, out_mask, h0, c0 = (
            t.contiguous() for t in (emb, token_mask, pk, value, attn_bias, qw, qb, out_mask, h0, c0))
        cell_ops = [t.contiguous() for t in cell_ops]
        kernels, rkernels, biases, cell_masks = (cell_ops[i * n_cells:(i + 1) * n_cells] for i in range(4))
        (h_last, c_last), (hidden, h_start, c_in0, zs, c_ps) = decoder_fwd(
            emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels, biases, cell_masks, out_mask, h0, c0)
        ctx.n_cells = n_cells
        ctx.save_for_backward(emb, token_mask, pk, value, attn_bias, qw, qb, out_mask, h_start, c_in0,
                              *kernels, *rkernels, *cell_masks, *zs, *c_ps)
        return hidden, h_last, c_last

    @staticmethod
    def backward(ctx, dhidden, dh_last, dc_last):
        n = ctx.n_cells
        emb, token_mask, pk, value, attn_bias, qw, qb, out_mask, h_start, c_in0, *rest = ctx.saved_tensors
        kernels, rkernels, cell_masks, zs, c_ps = (rest[i * n:(i + 1) * n] for i in range(5))
        dt = emb.dtype
        # the attention trajectory, recomputed outside the loop
        q = h_start @ qw + qb
        probs = torch.softmax(torch.einsum("nbh,bsh->nbs", q, pk) + attn_bias[None], dim=-1)
        dh0, dc0, dzs, demb, dctx, dscores, dq = decoder_bwd(
            dhidden.to(dt).contiguous(), dh_last.to(dt).contiguous(), dc_last.to(dt).contiguous(), token_mask,
            probs.contiguous(), c_in0, pk, value, qw, kernels, rkernels, cell_masks, out_mask, zs, c_ps,
            emb.shape[-1])
        dkernels, drkernels, dbiases, dqw, dqb, dpk, dvalue, dattn_bias = _decoder_bwd_tail(
            emb, token_mask, pk, value, cell_masks, h_start, zs, c_ps, q, probs, dzs, dctx, dscores, dq)
        needs = ctx.needs_input_grad
        zeros = lambda i, t: torch.zeros_like(t) if needs[i] else None
        return (None, demb, zeros(2, token_mask), dpk, dvalue, dattn_bias, dqw, dqb, zeros(8, out_mask), dh0, dc0,
                *dkernels, *drkernels, *dbiases, *[zeros(11 + 3 * n + i, m) for i, m in enumerate(cell_masks)])


def decoder_scan_lstm(emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels, biases, cell_masks, out_mask,
                      h0, c0):
    """Teacher-forced decoder loop: (hidden [N,B,H], h_last [B,H], c_last [B,H]).

    :param emb: [N,B,He] embedded tokens after embedding dropout
    :param token_mask: [N,B,1] float pad gate
    :param pk: [B,S,H] projected keys; ``value`` [B,S,Dv] listener output
    :param attn_bias: [B,S] additive mask (0 valid, -1e9 padded)
    :param qw: [H,H] query projection (in x out), ``qb`` [H]
    :param kernels, rkernels, biases: per cell [in_i,4H], [H,4H], [4H]
    :param cell_masks: per cell [B,in_i] dropout masks (ones when disabled); ``out_mask`` [B,H]
    :param h0, c0: [B,H] initial threaded state

    Every operand is in the compute type.  Kernels K2 / K3 run on a CUDA
    tensor, their plain versions on a CPU tensor.
    """
    return _DecoderScan.apply(len(kernels), emb, token_mask, pk, value, attn_bias, qw, qb, out_mask, h0, c0,
                              *kernels, *rkernels, *biases, *cell_masks)
