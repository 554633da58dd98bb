"""CTC negative log-likelihood (Graves et al. 2006) in plain float32: the
forward (alpha) and backward (beta) recursions over the blank-interleaved
label lattice in log space, one frame at a time for all rows at once, and
the gradient from the state posteriors, ``softmax - occupancy``."""

from __future__ import annotations

import torch

#: log of zero, kept finite so that sums of dead states stay finite
NEG = -1.0e30


def _lse3(a, b, c):
    return torch.logsumexp(torch.stack([a, b, c]), dim=0)


class _CTC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, frames, label_lengths, blank):
        b, t, _ = logits.shape
        dev = logits.device
        logp = torch.log_softmax(logits.float(), dim=-1)
        s = 2 * labels.shape[1] + 1
        ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
        ext[:, 1::2] = labels.long()
        pos = torch.arange(s, device=dev)[None]
        in_lat = pos < (2 * label_lengths[:, None] + 1)
        prev2 = torch.cat([torch.full((b, 2), blank, dtype=torch.long, device=dev),
                           ext[:, :-2]], dim=1)
        skip = (ext != blank) & (ext != prev2) & (pos >= 2)
        emit = logp.gather(2, ext[:, None, :].expand(b, t, s))  # [B, T, S]
        neg = torch.full((b, s), NEG, device=dev)
        alphas = torch.empty((t, b, s), device=dev)
        alpha = torch.where((pos < 2) & in_lat, emit[:, 0], neg)
        alphas[0] = alpha
        for i in range(1, t):
            a1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
            a2 = torch.where(skip, torch.cat([neg[:, :2], alpha[:, :-2]], dim=1), neg)
            new = torch.where(in_lat, _lse3(alpha, a1, a2) + emit[:, i], neg)
            alpha = torch.where((i < frames)[:, None], new, alpha)
            alphas[i] = alpha
        end = 2 * label_lengths
        last = alpha.gather(1, end[:, None])[:, 0]
        before = alpha.gather(1, (end - 1).clamp_min(0)[:, None])[:, 0]
        before = torch.where(label_lengths > 0, before, torch.full_like(before, NEG))
        nll = -torch.logaddexp(last, before)
        ctx.save_for_backward(logp, emit, alphas, ext, skip, in_lat, frames, label_lengths, nll)
        return nll

    @staticmethod
    def backward(ctx, grad):
        logp, emit, alphas, ext, skip, in_lat, frames, label_lengths, nll = ctx.saved_tensors
        t, b, s = alphas.shape
        dev = logp.device
        neg = torch.full((b, s), NEG, device=dev)
        pos = torch.arange(s, device=dev)[None]
        end = 2 * label_lengths[:, None]
        start = ((pos == end) | ((pos == end - 1) & (label_lengths[:, None] > 0))) & in_lat
        start_beta = torch.where(start, torch.zeros_like(neg), neg)
        skip_next = torch.cat([skip[:, 2:], torch.zeros_like(skip[:, :2])], dim=1)
        occ = torch.zeros_like(logp)
        beta = neg
        for i in range(t - 1, -1, -1):
            if i < t - 1:
                nxt = beta + emit[:, i + 1]
                b1 = torch.cat([nxt[:, 1:], neg[:, :1]], dim=1)
                b2 = torch.where(skip_next, torch.cat([nxt[:, 2:], neg[:, :2]], dim=1), neg)
                beta = torch.where(in_lat, _lse3(nxt, b1, b2), neg)
            # a row's last frame starts its beta; frames past it take no part
            beta = torch.where((i == frames - 1)[:, None], start_beta, beta)
            beta = torch.where((i < frames)[:, None], beta, neg)
            post = torch.exp(alphas[i] + beta + nll[:, None])
            occ[:, i].scatter_add_(1, ext, post)
        valid = (torch.arange(t, device=dev)[None] < frames[:, None])[..., None]
        dlogits = torch.where(valid, logp.exp() - occ, torch.zeros_like(occ))
        return dlogits * grad[:, None, None], None, None, None, None


def ctc_nll(logits: torch.Tensor, labels: torch.Tensor, frames: torch.Tensor,
            label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """``[B]`` negative log-likelihoods of ``labels [B, L]`` (the first
    ``label_lengths`` of each row) under ``logits [B, T, V]`` over each
    row's first ``frames`` frames; differentiable in the logits."""
    dev = logits.device
    return _CTC.apply(logits, labels.to(dev), frames.long().to(dev),
                      label_lengths.long().to(dev), blank)
