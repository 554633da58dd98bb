"""Quaternion dense and convolution ops in plain PyTorch.

Counterpart of ``qasr/ops/qlinalg.py``, formula for formula: ``qconv`` /
``qdense`` are the block path (one real conv/GEMM on the 4x-expanded
kernel, 16 block products); ``qdense_fast`` and ``qdense_fast8`` the
10-product and exact rank-8 schemes as batched GEMMs (``qdense_fast8`` is
kernel B's plain version); ``qconv_fast`` (one grouped conv of 10 groups),
``qconv_fast10`` and ``qconv_fast8`` (10 and 8 plain convs of the input
combos) the packed XLA conv arms; ``qdense_fast8_from_stacked`` the rank-8
dense layer fed by the conv chain's stacked output; and
``qconv_expanded_oracle`` the test oracle. The JAX package runs all of
these on plain XLA, so the port runs them on library ops (cuDNN convs,
cuBLAS GEMMs): none has a kernel of its own. Products are summed in f32
where the reference asks for ``preferred_element_type=f32``; the convs
return their products in the compute dtype, as XLA's do.

Layouts: activations packed ``[..., 4*Cin]`` component-major, NHWC-style;
weights stacked ``[4, kh, kw, Cin, Cout]`` / ``[4, Cin, Cout]``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from qasr_torch.ops.quaternion import (
    O8,
    OUT_COMBO,
    U8,
    V8,
    W_COMBO,
    X_COMBO,
    combine_weights,
    device_table,
    hamilton_expand,
)
from qasr_torch.ops.kernels.qconv_ft import SCHEME8, _combo


def qdense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quaternion dense: ``[..., 4*Cin] @ [4, Cin, Cout] -> [..., 4*Cout]``."""
    if w.ndim != 3 or w.shape[0] != 4:
        raise ValueError(f"dense weights must be [4, Cin, Cout], got {tuple(w.shape)}")
    return x @ hamilton_expand(w).to(x.dtype)


def _same_padding(kernel: Sequence[int]) -> tuple[int, ...]:
    if any(k % 2 == 0 for k in kernel):
        raise ValueError(f"SAME padding needs odd kernels here, got {tuple(kernel)}")
    return tuple((k - 1) // 2 for k in kernel)


def _conv_args(x: torch.Tensor, w: torch.Tensor, strides, padding) -> tuple:
    """Check a packed conv's operands; returns (spatial dims, strides,
    padding) for ``F.conv1d``/``F.conv2d``. ``padding`` is "SAME" (odd
    kernels, stride 1, as the encoders use) or "VALID"."""
    nsp = w.ndim - 3
    if w.shape[0] != 4 or nsp not in (1, 2):
        raise ValueError(f"conv weights must be [4, *k, Cin, Cout], got {tuple(w.shape)}")
    if x.ndim != nsp + 2:
        raise ValueError(f"x rank {x.ndim} incompatible with {nsp}-D conv")
    strides = tuple(strides) if strides is not None else (1,) * nsp
    if padding == "SAME":
        if any(s != 1 for s in strides):
            raise ValueError("SAME padding is supported at stride 1 only")
        pad = _same_padding(tuple(w.shape[1:-2]))
    elif padding == "VALID":
        pad = (0,) * nsp
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    return nsp, strides, pad


def _conv_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, nsp: int, strides, pad,
               groups: int = 1) -> torch.Tensor:
    """One real conv on NHWC ``x`` and HWIO ``w_hwio`` -> NHWC."""
    wt = w_hwio.permute(nsp + 1, nsp, *range(nsp))  # HWIO -> OIHW
    conv = F.conv1d if nsp == 1 else F.conv2d
    return conv(x.movedim(-1, 1), wt, stride=strides, padding=pad, groups=groups).movedim(1, -1)


def qconv(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    strides: Sequence[int] | None = None,
    padding: str = "SAME",
) -> torch.Tensor:
    """Quaternion 1-D/2-D convolution, NHWC packed: ``x [B, *sp, 4*Cin]``,
    ``w [4, *k, Cin, Cout]`` -> ``[B, *sp_out, 4*Cout]`` (block path).

    ``padding`` is "SAME" (odd kernels, stride 1, as the encoders use) or
    "VALID".
    """
    nsp, strides, pad = _conv_args(x, w, strides, padding)
    return _conv_nhwc(x, hamilton_expand(w).to(x.dtype), nsp, strides, pad)


def qconv_fast(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    strides: Sequence[int] | None = None,
    padding: str = "SAME",
) -> torch.Tensor:
    """Quaternion conv via the 10-product scheme as ONE grouped conv
    (``qasr/ops/qlinalg.py:qconv_fast``): the input combos ``[B, *sp,
    10*Cin]`` (X_COMBO, in x's dtype), the weight combos (W_COMBO, in w's
    dtype, then x's) as ten groups of one ``groups=10`` conv, its products in
    x's dtype recombined by OUT_COMBO in that dtype."""
    nsp, strides, pad = _conv_args(x, w, strides, padding)
    cin, cout = w.shape[-2], w.shape[-1]
    xs = x.reshape(*x.shape[:-1], 4, cin)
    xc = torch.einsum("...ak,pa->...pk", xs, device_table(X_COMBO, x.dtype, x.device))
    xc = xc.reshape(*x.shape[:-1], 10 * cin)
    # [10, *k, Cin, Cout] -> [*k, Cin, 10*Cout]: group p's outputs p*Cout..
    wc = combine_weights(w, x.dtype, W_COMBO).movedim(0, -2)
    wc = wc.reshape(*w.shape[1:-2], cin, 10 * cout)
    prods = _conv_nhwc(xc, wc, nsp, strides, pad, groups=10)
    prods = prods.reshape(*prods.shape[:-1], 10, cout)
    ys = torch.einsum("...pn,bp->...bn", prods, device_table(OUT_COMBO, prods.dtype, x.device))
    return ys.reshape(*prods.shape[:-2], 4 * cout)


def qconv_fast10(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    strides: Sequence[int] | None = None,
    padding: str = "SAME",
) -> torch.Tensor:
    """Quaternion conv via the 10-product scheme as TEN plain convs
    (``qasr/ops/qlinalg.py:qconv_fast10``): each input combo (one component
    or the sum of two, in x's dtype) through one ordinary conv of its weight
    combo, and the products added with OUT_COMBO's signs in x's dtype, in
    the reference's order. Autograd gives the matching ten-product dx and
    dW."""
    nsp, strides, pad = _conv_args(x, w, strides, padding)
    cin = w.shape[-2]
    xs = x.reshape(*x.shape[:-1], 4, cin)
    wc = combine_weights(w, x.dtype, W_COMBO)  # [10, *k, Cin, Cout]
    prods = []
    for p in range(10):
        terms = np.nonzero(X_COMBO[p])[0]
        xc = xs[..., int(terms[0]), :]
        if len(terms) == 2:
            xc = xc + xs[..., int(terms[1]), :]
        prods.append(_conv_nhwc(xc, wc[p], nsp, strides, pad))
    outs = []
    for b in range(4):
        acc = None
        for p in range(10):
            c = int(OUT_COMBO[b, p])
            if c == 0:
                continue
            term = prods[p] if c > 0 else -prods[p]
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def qconv_fast8(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    strides: Sequence[int] | None = None,
    padding: str = "SAME",
) -> torch.Tensor:
    """Quaternion conv via the exact rank-8 scheme as EIGHT plain convs,
    packed layout (``qasr/ops/qlinalg.py:qconv_fast8``): each input combo
    formed as ``_scaled`` forms it (each coefficient rounded to x's dtype,
    each scaled term rounded, then their sum), one ordinary conv of its U8
    weight combo, products in x's dtype, the O8 recombination in f32 and
    one rounding to x's dtype."""
    nsp, strides, pad = _conv_args(x, w, strides, padding)
    cin, cout = w.shape[-2], w.shape[-1]
    xs = x.reshape(*x.shape[:-1], 4, cin)
    wc = combine_weights(w, x.dtype, U8)  # [8, *k, Cin, Cout]
    prods = [_conv_nhwc(_combo(xs, terms, dim=-2), wc[p], nsp, strides, pad)
             for p, terms in enumerate(SCHEME8.fwd_in)]
    stacked = torch.stack(prods, dim=-2)  # [B, *sp, 8, Cout]
    ys = torch.einsum("...pn,bp->...bn", stacked.float(),
                      device_table(O8, torch.float32, x.device))
    return ys.reshape(*stacked.shape[:-2], 4 * cout).to(x.dtype)


def qconv_expanded_oracle(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    strides: Sequence[int] | None = None,
    padding: str = "SAME",
) -> torch.Tensor:
    """Test oracle: the explicitly 4x-expanded real conv
    (``qasr/ops/qlinalg.py:qconv_expanded_oracle``, the reference's exact
    computation at ``Precision.HIGHEST``), here in f64 so that no TF32 or
    reduced-precision conv can enter, returned in f32."""
    nsp, strides, pad = _conv_args(x, w, strides, padding)
    y = _conv_nhwc(x.double(), hamilton_expand(w.double()), nsp, strides, pad)
    return y.float()


def qdense_fast8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quaternion dense via the exact rank-8 scheme: 8 batched GEMMs with
    2-sparse input combos (V8) and U8-combined weights in x's dtype, their
    products summed in f32 (``preferred_element_type=f32``, as the
    reference), a dense O8 recombination in f32 and one rounding at the
    end."""
    if w.ndim != 3 or w.shape[0] != 4:
        raise ValueError(f"dense weights must be [4, Cin, Cout], got {tuple(w.shape)}")
    k = w.shape[1]
    xs = x.reshape(*x.shape[:-1], 4, k)
    v8 = device_table(V8, x.dtype, x.device)
    xc = torch.einsum("...ak,pa->...pk", xs, v8)
    wc = combine_weights(w, x.dtype)  # [8, K, N]
    prods = torch.einsum("...pk,pkn->...pn", xc.float(), wc.float())
    o8 = device_table(O8, torch.float32, x.device)
    ys = torch.einsum("...pn,bp->...bn", prods, o8)
    return ys.reshape(*x.shape[:-1], 4 * w.shape[2]).to(x.dtype)


def qdense_fast(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quaternion dense via the 10-product scheme
    (``qasr/ops/qlinalg.py:qdense_fast``): 10 batched GEMMs of the X_COMBO
    input combos (x's dtype) and the W_COMBO weight combos (w's dtype, then
    x's), their products summed in f32, the OUT_COMBO recombination in f32
    and one rounding to x's dtype."""
    if w.ndim != 3 or w.shape[0] != 4:
        raise ValueError(f"dense weights must be [4, Cin, Cout], got {tuple(w.shape)}")
    k = w.shape[1]
    xs = x.reshape(*x.shape[:-1], 4, k)
    xc = torch.einsum("...ak,pa->...pk", xs, device_table(X_COMBO, x.dtype, x.device))
    wc = combine_weights(w, x.dtype, W_COMBO)  # [10, K, N]
    prods = torch.einsum("...pk,pkn->...pn", xc.float(), wc.float())
    ys = torch.einsum("...pn,bp->...bn", prods, device_table(OUT_COMBO, torch.float32, x.device))
    return ys.reshape(*x.shape[:-1], 4 * w.shape[2]).to(x.dtype)


def qdense_fast8_from_stacked(x_st: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Rank-8 quaternion dense on the conv chain's STACKED output
    (``qasr/ops/qlinalg.py:qdense_fast8_from_stacked``): ``x_st [B, 4, F,
    T, C]``, ``w [4, F*C, N]`` (K ordered F-major, C-minor, as the packed
    path's first dense kernel) -> packed ``[B, T, 4*N]``. The V8 input
    combos in x's dtype, the U8 weight combos in x's dtype, the products
    summed in f32, the O8 recombination in f32, one rounding."""
    if w.ndim != 3 or w.shape[0] != 4:
        raise ValueError(f"dense weights must be [4, K, N], got {tuple(w.shape)}")
    b, four, f, t, c = x_st.shape
    if four != 4 or w.shape[1] != f * c:
        raise ValueError(
            f"stacked dense expects [B,4,F,T,C] with F*C == K; got {tuple(x_st.shape)}"
            f" vs K={w.shape[1]}"
        )
    n = w.shape[2]
    xc = torch.einsum("baftc,pa->bptfc", x_st, device_table(V8, x_st.dtype, x_st.device))
    xc = xc.reshape(b, 8, t, f * c)
    wc = combine_weights(w, x_st.dtype)  # [8, K, N]
    prods = torch.einsum("bptk,pkn->bptn", xc.float(), wc.float())
    ys = torch.einsum("bptn,qp->btqn", prods, device_table(O8, torch.float32, x_st.device))
    return ys.reshape(b, t, 4 * n).to(x_st.dtype)
