"""Sequence parallelism: the halo-exchange conv and the chunked-alpha CTC
(counterpart of ``qasr/parallel/seq_parallel.py``).

For very long utterances the time axis is split over a mesh axis: rank k of
the axis holds frames ``[k T/n, (k+1) T/n)`` of every row. Both functions
take and return this rank's chunk.

* :func:`qconv2d_seq_parallel`: a conv with a ``(kh, kw)`` kernel needs the
  ``(kh-1)/2`` boundary frames of each neighbour, which an ``all_gather`` of
  every rank's two edges brings (zeros at the global edges, as SAME padding
  has); the local conv is then VALID in time and SAME in frequency. On the
  card the ``fast8`` arm runs kernel A: SAME over the halo-extended chunk,
  whose first and last ``(kh-1)/2`` output frames are then cut off (they are
  the VALID conv's frames exactly). The backward of the exchange sends each
  halo's gradient back to the rank that owns its frames.
* :func:`ctc_loss_seq_parallel`: each rank forms only its ``[B, T/n, S]``
  emissions; the ``[B, S]`` alpha column passes from rank k to k+1 over n
  stages. Every rank scans its chunk in every stage and keeps the result
  only when it is live, as the reference's SPMD program does; ``broadcast``
  hands the live rank's alpha on.

Every exchange is an ``all_gather`` or a ``broadcast`` (see
``qasr_torch.parallel.collectives``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qasr_torch.models.layers import stacked_to_tf_packed, tf_packed_to_stacked
from qasr_torch.ops.ctc import (
    alpha_pre,
    build_lattice,
    lattice_emissions,
    loglik_from_alpha,
    log_softmax_f32,
    make_alpha_step,
)
from qasr_torch.ops.kernels.qconv_chain import chain_layer
from qasr_torch.ops.qlinalg import qconv
from qasr_torch.parallel.collectives import AllSum, Broadcast, gather_list
from qasr_torch.parallel.mesh import DATA_AXIS, Mesh


class _HaloExchange(torch.autograd.Function):
    """``[B, t, ...] -> [B, t + 2h, ...]``: this rank's chunk with the
    previous rank's last ``h`` frames before it and the next rank's first
    ``h`` after it (zeros at the global edges). Backward: each halo's
    gradient goes back to its owner and is added to its edge frames."""

    @staticmethod
    def forward(ctx, x, h, idx, n, group):
        ctx.h, ctx.idx, ctx.n, ctx.group = h, idx, n, group
        edges = gather_list(torch.stack([x[:, :h], x[:, -h:]]), group)
        zeros = torch.zeros_like(x[:, :h])
        left = edges[idx - 1][1] if idx > 0 else zeros
        right = edges[idx + 1][0] if idx < n - 1 else zeros
        return torch.cat([left, x, right], dim=1)

    @staticmethod
    def backward(ctx, g):
        h, idx, n = ctx.h, ctx.idx, ctx.n
        dx = g[:, h:-h].clone()
        sent = gather_list(torch.stack([g[:, :h], g[:, -h:]]), ctx.group)
        if idx < n - 1:  # my last frames were the next rank's left halo
            dx[:, -h:] += sent[idx + 1][0]
        if idx > 0:  # my first frames were the previous rank's right halo
            dx[:, :h] += sent[idx - 1][1]
        return dx, None, None, None, None


def qconv2d_seq_parallel(
    x: torch.Tensor,
    w: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = DATA_AXIS,
    variant: str = "auto",
) -> torch.Tensor:
    """Quaternion conv2d with the time axis split over ``axis``.

    ``x``: this rank's ``[B, T/n, F, 4*Cin]`` chunk (packed); ``w``: ``[4,
    kh, kw, Cin, Cout]`` (kh odd), in x's dtype for the compute; SAME
    padding, stride 1. Returns this rank's ``[B, T/n, F, 4*Cout]`` chunk.

    ``variant``: ``"auto"`` takes the rank-8 arm at >= 128 quaternion
    channels and the block conv below (the reference's rule); ``"fast8"``
    is kernel A (forward) and C (backward) on a CUDA tensor, their plain
    versions on the CPU; ``"block"`` is ``qasr_torch.ops.qlinalg.qconv``.
    """
    kh, kw = w.shape[1], w.shape[2]
    if kh % 2 == 0:
        raise ValueError("sequence-parallel conv requires an odd time kernel")
    hh = (kh - 1) // 2
    n = mesh.shape[axis]
    cin, cout = w.shape[-2], w.shape[-1]
    if variant == "auto":
        variant = "fast8" if min(cin, cout) >= 128 else "block"
    if variant not in ("fast8", "block"):
        raise ValueError(f"unknown variant {variant!r} (choose auto | block | fast8)")
    t_local = x.shape[1]
    if hh > 0 and n > 1:
        if t_local < hh:
            raise ValueError(f"a chunk of {t_local} frames is shorter than the halo {hh}")
        x_ext = _HaloExchange.apply(x, hh, mesh.index(axis), n, mesh.group(axis))
    else:
        x_ext = F.pad(x, (0, 0, 0, 0, hh, hh))
    if variant == "fast8":
        # stacked F-major [B, 4, F, T + 2h, Cin]; SAME over the extended
        # chunk, then the halo frames' outputs cut off: VALID in time
        x_st = tf_packed_to_stacked(x_ext).contiguous()
        zero_bias = torch.zeros(4 * cout, device=x.device)
        y_st = chain_layer(x_st, w, zero_bias, None, scheme="fast8")
        return stacked_to_tf_packed(y_st[:, :, :, hh:hh + t_local]).contiguous()
    pw = (kw - 1) // 2
    return qconv(F.pad(x_ext, (0, 0, pw, kw - 1 - pw)), w, padding="VALID")


def ctc_loss_seq_parallel(
    logits: torch.Tensor,
    labels: torch.Tensor,
    logit_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = DATA_AXIS,
    blank_id: int = 0,
) -> torch.Tensor:
    """CTC loss with the time axis of the logits split over ``axis``.

    ``logits``: this rank's ``[B, T/n, V]`` chunk; ``labels [B, L]``,
    ``logit_lengths [B]`` and ``label_lengths [B]`` whole on every rank.
    Returns the ``[B]`` losses (``-log p``, as ``qasr.ops.ctc.ctc_loss``),
    the same on every rank; differentiable, each rank getting the gradient
    of its own chunk. No rank forms more than its ``[B, T/n, S]``
    emissions.
    """
    n = mesh.shape[axis]
    idx = mesh.index(axis) if n > 1 else 0
    b, chunk, _ = logits.shape
    s = 2 * labels.shape[1] + 1
    labels = labels.long()
    logit_lengths = logit_lengths.long()
    label_lengths = label_lengths.long()
    z, can_skip, in_lattice, s_valid = build_lattice(labels, label_lengths, blank_id=blank_id)
    em = lattice_emissions(log_softmax_f32(logits), z)  # [B, T/n, S]: this chunk only
    step = make_alpha_step(can_skip, in_lattice, logit_lengths)
    t0 = idx * chunk  # the global frame index of this rank's first frame
    ranks = mesh.group_ranks(axis) if n > 1 else [mesh.rank]
    group = mesh.group(axis)
    alpha = alpha_pre(b, s, device=logits.device)
    for k in range(n):
        out = alpha
        for t in range(chunk):
            out, _ = step(out, (em[:, t], t0 + t))
        # masked, not selected: every rank's alpha then depends on its scan,
        # so every rank's graph holds each broadcast, whose backward is a
        # collective
        alpha = torch.where(torch.tensor(idx == k, device=alpha.device), out, alpha)
        if k < n - 1:  # rank k's alpha on to every rank; rank k + 1 scans it next
            alpha = Broadcast.apply(alpha, ranks[k], group)
    # the last rank holds the final alpha
    nll = -loglik_from_alpha(alpha, s_valid, label_lengths)
    if n == 1:
        return nll
    live = torch.tensor(idx == n - 1, device=nll.device)
    return AllSum.apply(torch.where(live, nll, torch.zeros_like(nll)), group)
