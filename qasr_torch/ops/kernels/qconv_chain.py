"""One layer of the fat conv chain: ``z = bias + qconv(prelu_prev(x))``,
forward and backward, in the rank-8 (``"fast8"``) or the 10-product
(``"fast10"``) scheme.

Counterpart of ``qasr/ops/pallas/qconv_chain.py:chain_layer`` and its custom
VJP (``_make_chain_layer``). The previous layer's split PReLU is fused into
the conv's prologue and the bias into its epilogue, so a chain of layers
passes pre-activations and never materialises the activation between convs.
The TPU version kept the whole chain in a margin-padded buffer because its
BlockSpecs could not express the SAME-padding halo; the port's kernels read
out-of-range taps as zero themselves, so the port works on the plain stacked
layout ``[B, 4, F, T, C]`` and has no entry/exit pad.

On a CUDA tensor :class:`ChainLayerFn` runs kernel A (``fast8``) or F
(``fast10``) forward and kernel C or G backward (dx and the PReLU's dalpha
in one call); dW is plain PyTorch, as the JAX package left it to XLA
(``_ft_dw_impl``), and db is a sum.
"""

from __future__ import annotations

import torch

from qasr_torch.ops.kernels.qconv_dx import qconv_dx8, qconv_dx10
from qasr_torch.ops.kernels.qconv_ft import (
    SCHEMES,
    _combo,
    _prelu_stacked,
    qconv_ft8,
    qconv_ft10,
    qconv_stacked_plain,
)

# per scheme: the forward kernel's and the transposed kernel's wrappers
_KERNELS = {"fast8": (qconv_ft8, qconv_dx8), "fast10": (qconv_ft10, qconv_dx10)}


def qconv_dw(x_st: torch.Tensor, dz: torch.Tensor, kernel_size, scheme: str = "fast8") -> torch.Tensor:
    """dW of the stacked conv in ``scheme`` (after ``qconv_ft.py:_ft_dw_impl``):
    the transpose of :func:`~qasr_torch.ops.kernels.qconv_ft.qconv_stacked_plain`
    in w.

    ``x_st [B,4,F,T,Cin]`` (the conv's input, after any PReLU) and ``dz
    [B,4,F,T,Cout]`` in the compute dtype. Per product p, one correlation
    ``conv2d_weight`` of the input combo ``V[p] . x`` with the output combo
    ``O[:, p] . dz``; the U fold takes the P results back to
    ``[4, kh, kw, Cin, Cout]`` in f32.
    """
    sc = SCHEMES[scheme]
    kh, kw = kernel_size
    cin, cout = x_st.shape[-1], dz.shape[-1]
    o = torch.as_tensor(sc.o_mat, dtype=torch.float32, device=dz.device)
    dzc = torch.einsum("bqftn,qp->pbftn", dz.float(), o).to(dz.dtype)
    pad = ((kw - 1) // 2, (kh - 1) // 2)
    dwc = []
    for p, terms in enumerate(sc.fwd_in):
        xc = _combo(x_st, terms)  # [B, F, T, Cin]
        g = torch.nn.grad.conv2d_weight(
            xc.permute(0, 3, 1, 2), (cout, cin, kw, kh), dzc[p].permute(0, 3, 1, 2),
            padding=pad,
        )  # [Cout, Cin, kw (F), kh (T)]
        dwc.append(g.float().permute(3, 2, 1, 0))  # [kh, kw, Cin, Cout]
    u = torch.as_tensor(sc.u, dtype=torch.float32, device=dz.device)
    return torch.einsum("pa,phwkn->ahwkn", u, torch.stack(dwc))


class ChainLayerFn(torch.autograd.Function):
    """``z = bias + qconv(prelu_alpha(x))`` in ``scheme``: kernel A or F
    forward; backward kernel C or G for dx and dalpha, :func:`qconv_dw` for
    dW, a sum for db.

    ``x [B,4,F,T,Cin]`` in the compute dtype (the previous layer's
    pre-activation, or the chain's activated input when ``alpha`` is None);
    ``w``, ``bias`` and ``alpha`` are the f32 master parameters. Gradients
    come back in each input's dtype.
    """

    @staticmethod
    def forward(ctx, x, w, bias, alpha, scheme="fast8"):
        ctx.save_for_backward(x, w, alpha)
        ctx.param_dtypes = (w.dtype, bias.dtype)
        ctx.scheme = scheme
        return _KERNELS[scheme][0](x, w, bias, alpha)

    @staticmethod
    def backward(ctx, dz):
        x, w, alpha = ctx.saved_tensors
        w_dtype, b_dtype = ctx.param_dtypes
        dz = dz.contiguous()
        dx = dalpha = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[3]:
            dx, dalpha = _KERNELS[ctx.scheme][1](dz, w, None if alpha is None else x, alpha)
            if alpha is not None:
                dalpha = dalpha.to(alpha.dtype)
        x_act = x if alpha is None else _prelu_stacked(x, alpha)
        dw = qconv_dw(x_act, dz, w.shape[1:3], ctx.scheme).to(w_dtype)
        db = dz.float().sum(dim=(0, 2, 3)).reshape(-1).to(b_dtype)
        return dx, dw, db, dalpha, None


def chain_layer(
    x_st: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    alpha_prev: torch.Tensor | None,
    *,
    scheme: str = "fast8",
    plain: bool = False,
) -> torch.Tensor:
    """``bias + qconv(prelu_{alpha_prev}(x_st))`` on ``[B, 4, F, T, Cin]`` in
    ``scheme`` (``"fast8"``: kernels A and C; ``"fast10"``: kernels F and G).

    ``alpha_prev`` is the PREVIOUS layer's PReLU slope vector ``[4*Cin]``, or
    None for the first chain layer, whose input is already activated.
    ``plain=True`` or a CPU tensor runs the plain PyTorch version under
    autograd (the card's reference path); otherwise a CUDA tensor goes
    through :class:`ChainLayerFn`.
    """
    if scheme not in _KERNELS:
        raise ValueError(f"unknown scheme {scheme!r} (choose fast8 | fast10)")
    if plain or not x_st.is_cuda:
        return qconv_stacked_plain(x_st, w, bias, alpha_prev, scheme=SCHEMES[scheme])
    return ChainLayerFn.apply(x_st, w, bias, alpha_prev, scheme)
