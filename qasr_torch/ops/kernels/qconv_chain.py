"""One layer of the fat conv chain: ``z = bias + qconv8(prelu_prev(x))``,
forward and backward.

Counterpart of ``qasr/ops/pallas/qconv_chain.py:chain_layer`` and its custom
VJP (``_make_chain_layer``). The previous layer's split PReLU is fused into
the conv's prologue and the bias into its epilogue, so a chain of layers
passes pre-activations and never materialises the activation between convs.
The TPU version kept the whole chain in a margin-padded buffer because its
BlockSpecs could not express the SAME-padding halo; kernels A and C read
out-of-range taps as zero themselves, so the port works on the plain stacked
layout ``[B, 4, F, T, C]`` and has no entry/exit pad.

On a CUDA tensor :class:`ChainLayerFn` runs kernel A forward and kernel C
backward (dx and the PReLU's dalpha in one call); dW is plain PyTorch, as
the JAX package left it to XLA (``_ft_dw_impl``), and db is a sum.
"""

from __future__ import annotations

import torch

from qasr_torch.ops.kernels.qconv_dx8 import qconv_dx8
from qasr_torch.ops.kernels.qconv_ft import (
    SCHEME8,
    _prelu_stacked,
    qconv_fast8_stacked_plain,
    qconv_ft8,
)
from qasr_torch.ops.quaternion import O8, U8


def qconv_dw8(x_st: torch.Tensor, dz: torch.Tensor, kernel_size) -> torch.Tensor:
    """dW of the rank-8 stacked conv (after ``qconv_ft.py:_ft_dw_impl``): the
    transpose of ``qconv_fast8_stacked_plain`` in w.

    ``x_st [B,4,F,T,Cin]`` (the conv's input, after any PReLU) and ``dz
    [B,4,F,T,Cout]`` in the compute dtype. Per product p, one correlation
    ``conv2d_weight`` of the input combo ``V8[p] . x`` with the output combo
    ``O8[:, p] . dz``; the U8 fold takes the eight results back to
    ``[4, kh, kw, Cin, Cout]`` in f32.
    """
    kh, kw = kernel_size
    cin, cout = x_st.shape[-1], dz.shape[-1]
    o8 = torch.as_tensor(O8, dtype=torch.float32, device=dz.device)
    dzc = torch.einsum("bqftn,qp->pbftn", dz.float(), o8).to(dz.dtype)
    pad = ((kw - 1) // 2, (kh - 1) // 2)
    dwc = []
    for p, ((a1, c1), (a2, c2)) in enumerate(SCHEME8.fwd_in):
        xc = x_st[:, a1] * c1 + x_st[:, a2] * c2  # [B, F, T, Cin]
        g = torch.nn.grad.conv2d_weight(
            xc.permute(0, 3, 1, 2), (cout, cin, kw, kh), dzc[p].permute(0, 3, 1, 2),
            padding=pad,
        )  # [Cout, Cin, kw (F), kh (T)]
        dwc.append(g.float().permute(3, 2, 1, 0))  # [kh, kw, Cin, Cout]
    u8 = torch.as_tensor(U8, dtype=torch.float32, device=dz.device)
    return torch.einsum("pa,phwkn->ahwkn", u8, torch.stack(dwc))


class ChainLayerFn(torch.autograd.Function):
    """``z = bias + qconv8(prelu_alpha(x))``: kernel A forward; backward
    kernel C for dx and dalpha, :func:`qconv_dw8` for dW, a sum for db.

    ``x [B,4,F,T,Cin]`` in the compute dtype (the previous layer's
    pre-activation, or the chain's activated input when ``alpha`` is None);
    ``w``, ``bias`` and ``alpha`` are the f32 master parameters. Gradients
    come back in each input's dtype.
    """

    @staticmethod
    def forward(ctx, x, w, bias, alpha):
        ctx.save_for_backward(x, w, alpha)
        ctx.param_dtypes = (w.dtype, bias.dtype)
        return qconv_ft8(x, w, bias, alpha)

    @staticmethod
    def backward(ctx, dz):
        x, w, alpha = ctx.saved_tensors
        w_dtype, b_dtype = ctx.param_dtypes
        dz = dz.contiguous()
        dx = dalpha = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[3]:
            dx, dalpha = qconv_dx8(dz, w, None if alpha is None else x, alpha)
            if alpha is not None:
                dalpha = dalpha.to(alpha.dtype)
        x_act = x if alpha is None else _prelu_stacked(x, alpha)
        dw = qconv_dw8(x_act, dz, w.shape[1:3]).to(w_dtype)
        db = dz.float().sum(dim=(0, 2, 3)).reshape(-1).to(b_dtype)
        return dx, dw, db, dalpha


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
    ``plain=True`` or a CPU tensor runs the plain PyTorch version under
    autograd (the card's reference path); otherwise a CUDA tensor goes
    through :class:`ChainLayerFn` (kernels A and C).
    """
    if plain or not x_st.is_cuda:
        return qconv_fast8_stacked_plain(x_st, w, bias, alpha_prev)
    return ChainLayerFn.apply(x_st, w, bias, alpha_prev)
