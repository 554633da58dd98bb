"""CTC loss and greedy decoding on the device (counterpart of
``qasr/ops/ctc.py``).

The JAX package computes the CTC lattice in XLA, not in Pallas, so the loss
here is the library's ``F.ctc_loss`` on the f32 log-softmax. The lattice
functions of the reference's own loss (``build_lattice`` ... 
``loglik_from_alpha``) are kept in plain PyTorch for the sequence-parallel
loss (``qasr_torch.parallel.seq_parallel``), which carries the alpha column
from rank to rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: the loss the reference reports for an utterance whose labels cannot be
#: emitted in its frames (its log-space floor, ``-LOG_EPS``)
INFEASIBLE_LOSS = 1e30
#: the lattice's effective -inf, finite under arithmetic (``LOG_EPS``)
LOG_EPS = -1e30


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


def _logsumexp3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Stable logsumexp of three tensors with LOG_EPS as -inf; where all three
    are dead the result is LOG_EPS and no log(0) enters the graph."""
    m = torch.maximum(torch.maximum(a, b), c)
    degenerate = m <= LOG_EPS / 2
    m_safe = torch.where(degenerate, torch.zeros_like(m), m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe)
    s = torch.where(degenerate, torch.ones_like(s), s)
    return torch.where(degenerate, torch.full_like(m, LOG_EPS), m_safe + torch.log(s))


def build_lattice(labels: torch.Tensor, label_lengths: torch.Tensor, *, blank_id: int):
    """The blank-interleaved lattice of ``labels [B, L]``: (z ``[B, S]``
    symbols, can_skip ``[B, S]``, in_lattice ``[B, S]``, s_valid ``[B, 1]``)
    for S = 2L + 1."""
    b, l = labels.shape
    s = 2 * l + 1
    z = torch.full((b, s), blank_id, dtype=labels.dtype, device=labels.device)
    z[:, 1::2] = labels
    pos = torch.arange(s, device=labels.device)[None, :]
    s_valid = 2 * label_lengths[:, None] + 1
    in_lattice = pos < s_valid
    # the skip (s - 2) is allowed where z_s is a label other than z_{s-2}
    z_m2 = F.pad(z, (2, 0), value=blank_id)[:, :s]
    can_skip = (z != blank_id) & (z != z_m2) & (pos >= 2)
    return z, can_skip, in_lattice, s_valid


def lattice_emissions(logp: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``em[b, t, s] = logp[b, t, z[b, s]]``, ``[B, T, S]`` (a gather: the
    reference's one-hot einsum at HIGHEST precision picks the same values)."""
    b, t, _ = logp.shape
    return logp.gather(2, z[:, None, :].expand(b, t, z.shape[1]))


def make_alpha_step(can_skip: torch.Tensor, in_lattice: torch.Tensor,
                    logit_lengths: torch.Tensor):
    """One frame of the log-space alpha recursion: ``step(alpha, (emit [B,
    S], t)) -> (alpha', None)``. Alpha before any frame is
    :func:`alpha_pre` (a log one-hot at state 0); past a row's last frame
    alpha stays as it is, so the final read is uniform across the batch."""
    s = can_skip.shape[1]

    def step(alpha, inputs):
        emit, t_idx = inputs
        a_m1 = F.pad(alpha, (1, 0), value=LOG_EPS)[:, :s]
        a_m2 = F.pad(alpha, (2, 0), value=LOG_EPS)[:, :s]
        a_m2 = torch.where(can_skip, a_m2, torch.full_like(a_m2, LOG_EPS))
        new = _logsumexp3(alpha, a_m1, a_m2) + emit
        new = torch.where(in_lattice, new, torch.full_like(new, LOG_EPS))
        active = (t_idx < logit_lengths)[:, None]
        return torch.where(active, new, alpha), None

    return step


def alpha_pre(b: int, s: int, device=None) -> torch.Tensor:
    """The pre-frame alpha carry ``[B, S]``: a log one-hot at state 0."""
    alpha = torch.full((b, s), LOG_EPS, dtype=torch.float32, device=device)
    alpha[:, 0] = 0.0
    return alpha


def loglik_from_alpha(alpha_final: torch.Tensor, s_valid: torch.Tensor,
                      label_lengths: torch.Tensor) -> torch.Tensor:
    """log p of each row from its final alpha column: the last blank or the
    last label state (only the blank path when a row has no labels)."""
    last = alpha_final.gather(1, s_valid - 1)[:, 0]
    second = alpha_final.gather(1, (s_valid - 2).clamp_min(0))[:, 0]
    second = torch.where(label_lengths > 0, second, torch.full_like(second, LOG_EPS))
    return _logsumexp3(last, second, torch.full_like(last, LOG_EPS))
