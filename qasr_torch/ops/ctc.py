"""CTC loss and greedy decoding on the device (counterpart of
``qasr/ops/ctc.py``).

The JAX package computes the CTC lattice in XLA, not in Pallas, so the loss
here is the library's ``F.ctc_loss`` on the f32 log-softmax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: the loss the reference reports for an utterance whose labels cannot be
#: emitted in its frames (its log-space floor, ``-LOG_EPS``)
INFEASIBLE_LOSS = 1e30


def log_softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the vocab in f32, whatever the logits' dtype."""
    return torch.log_softmax(logits.float(), dim=-1)


def ctc_greedy_decode(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    *,
    blank_id: int = 0,
    pad_id: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-path CTC decode: framewise argmax, collapse repeats, drop blanks.

    Returns (``[B, T]`` sequences left-packed and padded with ``pad_id``,
    ``[B]`` decoded lengths), on the logits' device.
    """
    b, t, _ = logits.shape
    path = torch.argmax(logits, dim=-1)  # [B, T]; ties -> first index
    t_idx = torch.arange(t, device=logits.device)[None, :]
    valid = t_idx < logit_lengths.to(logits.device)[:, None]
    prev = torch.nn.functional.pad(path, (1, 0), value=blank_id)[:, :t]
    keep = valid & (path != blank_id) & ((path != prev) | (t_idx == 0))
    out_pos = torch.cumsum(keep, dim=1) - 1
    out_pos = torch.where(keep, out_pos, torch.full_like(out_pos, t))  # -> dropped
    out = torch.full((b, t + 1), pad_id, dtype=path.dtype, device=logits.device)
    out.scatter_(1, out_pos, torch.where(keep, path, torch.full_like(path, pad_id)))
    return out[:, :t], keep.sum(dim=1)


def ctc_feasible(
    labels: torch.Tensor, logit_lengths: torch.Tensor, label_lengths: torch.Tensor
) -> torch.Tensor:
    """``[B]`` bool: whether CTC can emit each row's labels in its frames
    (L labels need L + (# adjacent repeats) frames)."""
    pos = torch.arange(labels.shape[1], device=labels.device)[None, 1:]
    repeats = (labels[:, 1:] == labels[:, :-1]) & (pos < label_lengths[:, None])
    return label_lengths + repeats.sum(dim=1) <= logit_lengths


def ctc_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    logit_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    *,
    blank_id: int = 0,
) -> torch.Tensor:
    """CTC negative log-likelihood per utterance, ``[B]`` f32.

    ``logits [B, T, V]`` (any float dtype; the lattice runs on the f32
    log-softmax), ``labels [B, L]``, ``logit_lengths [B]``, ``label_lengths
    [B]``. A row whose labels cannot be emitted in its frames gets the
    reference's finite ``INFEASIBLE_LOSS`` and a zero gradient, as
    ``qasr.ops.ctc.ctc_loss`` does (``zero_infinity`` zeroes the library's
    infinite loss and its gradient; the value is then replaced).
    """
    logp = log_softmax_f32(logits).transpose(0, 1)  # [T, B, V]
    labels = labels.long()
    logit_lengths = logit_lengths.long()
    label_lengths = label_lengths.long()
    nll = F.ctc_loss(
        logp, labels, logit_lengths, label_lengths,
        blank=blank_id, reduction="none", zero_infinity=True,
    )
    feasible = ctc_feasible(labels, logit_lengths, label_lengths)
    return torch.where(feasible, nll, torch.full_like(nll, INFEASIBLE_LOSS))
