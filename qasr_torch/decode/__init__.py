"""Decoding and scoring for the port (counterpart of ``qasr/decode``):
greedy and prefix-beam CTC decoding on the device, the native prefix beam
on the host, and PER scoring."""

from __future__ import annotations

import torch

from qasr_torch.decode.beam import ctc_beam_search_decode
from qasr_torch.decode.scoring import batch_per, edit_distance, per_counts
from qasr_torch.native import ctc_beam_decode_native
from qasr_torch.ops.ctc import ctc_greedy_decode


def ctc_beam_search_decode_host(logits, lengths, **kw):
    """Host-side (C++ threads) prefix beam search: the same search as
    :func:`ctc_beam_search_decode`, on numpy arrays or tensors (copied to
    the host), returning numpy arrays. There is no fallback: if the native
    library does not build, this raises."""
    if torch.is_tensor(logits):
        logits = logits.detach().float().cpu().numpy()
    if torch.is_tensor(lengths):
        lengths = lengths.cpu().numpy()
    return ctc_beam_decode_native(logits, lengths, **kw)


__all__ = [
    "ctc_greedy_decode",
    "ctc_beam_search_decode",
    "ctc_beam_search_decode_host",
    "batch_per",
    "edit_distance",
    "per_counts",
]
