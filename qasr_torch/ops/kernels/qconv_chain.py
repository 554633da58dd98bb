"""One layer of the fat conv chain: ``z = bias + qconv8(prelu_prev(x))``.

Counterpart of ``qasr/ops/pallas/qconv_chain.py:chain_layer`` (the TPU
kernel ``_fwd_kernel``): the previous layer's split PReLU is fused into the
conv's prologue and the bias into its epilogue, so a chain of layers passes
pre-activations and never materialises the activation between convs. The
TPU version kept the whole chain in a margin-padded buffer because its
BlockSpecs could not express the SAME-padding halo; kernel A reads
out-of-range taps as zero itself, so the port works on the plain stacked
layout ``[B, 4, F, T, C]`` and has no entry/exit pad.
"""

from __future__ import annotations

import torch

from qasr_torch.ops.kernels.qconv_ft import qconv_fast8_stacked_plain, qconv_ft8


def chain_layer(
    x_st: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    alpha_prev: torch.Tensor | None,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """``bias + qconv8(prelu_{alpha_prev}(x_st))`` on ``[B, 4, F, T, Cin]``.

    ``alpha_prev`` is the PREVIOUS layer's PReLU slope vector ``[4*Cin]``, or
    None for the first chain layer, whose input is already activated.
    ``plain=True`` runs the plain PyTorch version on any device (the card's
    reference path); otherwise a CUDA tensor goes through kernel A.
    """
    if plain:
        return qconv_fast8_stacked_plain(x_st, w, bias, alpha_prev)
    return qconv_ft8(x_st, w, bias, alpha_prev)
