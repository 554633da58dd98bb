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
in one call). dW is P correlations on cuDNN's wgrad, as the JAX package
left them to XLA (``_ft_dw_impl``); kernel K makes everything they read
(the PReLU, the input and output combos) and db in one pass.
"""

from __future__ import annotations

import torch

from qasr_torch.ops.kernels.qconv_dw_prep import qconv_dw_prep
from qasr_torch.ops.kernels.qconv_dx import qconv_dx8, qconv_dx10
from qasr_torch.ops.kernels.qconv_ft import SCHEMES, qconv_ft8, qconv_ft10, qconv_stacked_plain
from qasr_torch.ops.quaternion import device_table
from qasr_torch.utils.profiling import span

# per scheme: the forward kernel's and the transposed kernel's wrappers
_KERNELS = {"fast8": (qconv_ft8, qconv_dx8), "fast10": (qconv_ft10, qconv_dx10)}


def qconv_dw(
    x: torch.Tensor,
    dz: torch.Tensor,
    kernel_size,
    scheme: str = "fast8",
    alpha: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """dW and db of the stacked conv ``z = bias + qconv(prelu_alpha(x))`` in
    ``scheme`` (after ``qconv_ft.py:_ft_dw_impl``): the transpose of
    :func:`~qasr_torch.ops.kernels.qconv_ft.qconv_stacked_plain` in w, and
    the sum of dz.

    ``x [B,4,F,T,Cin]`` (the conv's input before the PReLU of ``alpha
    [4*Cin]``, or after it when ``alpha`` is None) and ``dz [B,4,F,T,Cout]``
    in the compute dtype. The input combos ``V[p] . prelu(x)``, the output
    combos ``O[:, p] . dz`` and db come from kernel K on CUDA tensors (it
    raises on what it cannot take), from its plain version on the CPU; per
    product p one correlation ``conv2d_weight``; the U fold takes the P
    results back to ``[4, kh, kw, Cin, Cout]`` in f32. db is ``[4*Cout]``
    f32.
    """
    sc = SCHEMES[scheme]
    kh, kw = kernel_size
    cin, cout = x.shape[-1], dz.shape[-1]
    xc, dzc, db = qconv_dw_prep(x, dz, alpha, scheme=sc)
    pad = ((kw - 1) // 2, (kh - 1) // 2)
    dwc = []
    for p in range(sc.n_prods):
        g = torch.nn.grad.conv2d_weight(
            xc[p].permute(0, 3, 1, 2), (cout, cin, kw, kh), dzc[p].permute(0, 3, 1, 2),
            padding=pad,
        )  # [Cout, Cin, kw (F), kh (T)]
        dwc.append(g.float().permute(3, 2, 1, 0))  # [kh, kw, Cin, Cout]
    u = device_table(sc.u, torch.float32, dz.device)
    return torch.einsum("pa,phwkn->ahwkn", u, torch.stack(dwc)), db


class ChainLayerFn(torch.autograd.Function):
    """``z = bias + qconv(prelu_alpha(x))`` in ``scheme``: kernel A or F
    forward; backward kernel C or G for dx and dalpha, :func:`qconv_dw`
    (kernel K and cuDNN's wgrad) for dW and db, under the span
    ``qasr.conv_dw``.

    ``x [B,4,F,T,Cin]`` in the compute dtype (the previous layer's
    pre-activation, or the chain's activated input when ``alpha`` is None);
    ``w`` is the kernel in the compute dtype (the layer casts its f32 master
    kernel, as the reference does, so a bf16 kernel's combos get bf16 U8
    coefficients); ``bias`` and ``alpha`` are the f32 master parameters.
    Gradients come back in each input's dtype.
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
        with span("qasr.conv_dw"):
            dw, db = qconv_dw(x, dz, w.shape[1:3], ctx.scheme, alpha)
            dw, db = dw.to(w_dtype), db.to(b_dtype)
        return dx, dw, db, dalpha, None


def takes_chain_fn(x_st: torch.Tensor, plain: bool = False) -> bool:
    """Whether :func:`chain_layer` runs this call through
    :class:`ChainLayerFn`: a CUDA tensor off the plain route. That node
    saves only its input, the kernel and the slopes, never its output, so a
    checkpoint around it frees nothing (``models/qcnn.py:segment``)."""
    return not plain and x_st.is_cuda


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
    through :class:`ChainLayerFn` (:func:`takes_chain_fn`).
    """
    if scheme not in _KERNELS:
        raise ValueError(f"unknown scheme {scheme!r} (choose fast8 | fast10)")
    if takes_chain_fn(x_st, plain):
        return ChainLayerFn.apply(x_st, w, bias, alpha_prev, scheme)
    return qconv_stacked_plain(x_st, w, bias, alpha_prev, scheme=SCHEMES[scheme])
