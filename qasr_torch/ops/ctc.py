"""CTC decoding on the device (counterpart of ``qasr/ops/ctc.py``; the CTC
loss comes with training)."""

from __future__ import annotations

import torch


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
