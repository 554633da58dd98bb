"""Quaternion dense and convolution ops in plain PyTorch.

Counterpart of ``qasr/ops/qlinalg.py``: ``qconv``/``qdense`` are the block
path (one real conv/GEMM on the 4x-expanded kernel, 16 block products), and
``qdense_fast8`` is the exact rank-8 scheme as 8 batched GEMMs — the plain
version of kernel B.

Layouts: activations packed ``[..., 4*Cin]`` component-major, NHWC-style;
weights stacked ``[4, kh, kw, Cin, Cout]`` / ``[4, Cin, Cout]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from qasr_torch.ops.quaternion import O8, V8, combine_weights, device_table, hamilton_expand


def qdense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quaternion dense: ``[..., 4*Cin] @ [4, Cin, Cout] -> [..., 4*Cout]``."""
    if w.ndim != 3 or w.shape[0] != 4:
        raise ValueError(f"dense weights must be [4, Cin, Cout], got {tuple(w.shape)}")
    return x @ hamilton_expand(w).to(x.dtype)


def _same_padding(kernel: Sequence[int]) -> tuple[int, ...]:
    if any(k % 2 == 0 for k in kernel):
        raise ValueError(f"SAME padding needs odd kernels here, got {tuple(kernel)}")
    return tuple((k - 1) // 2 for k in kernel)


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
    nsp = w.ndim - 3
    if w.shape[0] != 4 or nsp not in (1, 2):
        raise ValueError(f"conv weights must be [4, *k, Cin, Cout], got {tuple(w.shape)}")
    if x.ndim != nsp + 2:
        raise ValueError(f"x rank {x.ndim} incompatible with {nsp}-D conv")
    strides = tuple(strides) if strides is not None else (1,) * nsp
    kernel = tuple(w.shape[1:-2])
    if padding == "SAME":
        if any(s != 1 for s in strides):
            raise ValueError("SAME padding is supported at stride 1 only")
        pad = _same_padding(kernel)
    elif padding == "VALID":
        pad = (0,) * nsp
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    w_big = hamilton_expand(w).to(x.dtype)  # [*k, 4Cin, 4Cout]
    # NHWC -> NCHW, HWIO -> OIHW
    xc = x.movedim(-1, 1)
    wt = w_big.permute(nsp + 1, nsp, *range(nsp))
    conv = F.conv1d if nsp == 1 else F.conv2d
    y = conv(xc, wt, stride=strides, padding=pad)
    return y.movedim(1, -1)


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
