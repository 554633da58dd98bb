"""What the stacked quaternion conv's weight gradient reads: kernel K
(``qasr_torch/csrc/qconv_dw_prep.cu``) and its plain PyTorch version.

dW of ``z = bias + qconv(prelu_alpha(x))`` in a scheme of P products is P
correlations (:func:`qasr_torch.ops.kernels.qconv_chain.qconv_dw`, after the
JAX package's ``qconv_ft.py:_ft_dw_impl``), each of an input combo with an
output combo. This module makes, from the saved pre-activation ``x
[B,4,F,T,Cin]``, the previous layer's PReLU slopes ``alpha [4*Cin]`` (None
for a chain's first layer) and the cotangent ``dz [B,4,F,T,Cout]``:

    xc  [P,B,F,T,Cin]    V[p] . prelu_alpha(x)     in x's dtype
    dzc [P,B,F,T,Cout]   O[:, p] . dz              in dz's dtype
    db  [4*Cout]         dz summed over B, F, T    f32

Each p-slice of ``xc`` and ``dzc`` is contiguous, so its ``permute(0, 3, 1,
2)`` is the channels-last view cuDNN's wgrad reads. The plain version is
the CPU's route and the card's reference; the kernel gives its combos' bits
(the PReLU and the input combos rounded as ``qconv_ft.py:_combo`` rounds,
the output combos as the plain version's f32 GEMM and its cast) and db in
another summation order. :func:`qconv_dw_prep` takes the plain version for a
CPU tensor only; for a CUDA tensor it launches K or raises.
"""

from __future__ import annotations

import ctypes

import torch

from qasr_torch.ops.kernels import _build
from qasr_torch.ops.kernels.qconv_ft import (
    _DTYPE_CODE,
    _TABLES,
    SCHEME8,
    _check_cuda_tensor,
    _combo,
    _prelu_stacked,
    _Scheme,
)
from qasr_torch.ops.quaternion import device_table


def qconv_dw_prep_plain(
    x: torch.Tensor,
    dz: torch.Tensor,
    alpha: torch.Tensor | None = None,
    *,
    scheme: _Scheme = SCHEME8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel K: ``(xc, dzc, db)`` as the module docstring
    gives them. The PReLU as :func:`~qasr_torch.ops.kernels.qconv_ft._prelu_stacked`,
    each input combo by ``_combo`` in x's dtype, the output combos by one f32
    einsum cast to dz's dtype, db an f32 sum."""
    x_act = x if alpha is None else _prelu_stacked(x, alpha)
    xc = torch.stack([_combo(x_act, terms) for terms in scheme.fwd_in])
    o = device_table(scheme.o_mat, torch.float32, dz.device)
    dzc = torch.einsum("bqftn,qp->pbftn", dz.float(), o).to(dz.dtype)
    db = dz.float().sum(dim=(0, 2, 3)).reshape(-1)
    return xc, dzc, db


def qconv_dw_prep_cuda(
    x: torch.Tensor,
    dz: torch.Tensor,
    alpha: torch.Tensor | None = None,
    *,
    scheme: _Scheme = SCHEME8,
    lib=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel K. ``x [B,4,F,T,Cin]`` and ``dz [B,4,F,T,Cout]`` on one
    CUDA device, contiguous, both f32 or both bf16, Cin and Cout multiples
    of 8; ``alpha [4*Cin]`` f32 or None; ``lib`` a kernel library other than
    the package's. Raises on anything the kernel does not take, or when it
    fails to build or launch."""
    if x.ndim != 5 or x.shape[1] != 4 or dz.ndim != 5:
        raise ValueError(
            f"expected x [B,4,F,T,Cin] and dz [B,4,F,T,Cout], got {tuple(x.shape)} and "
            f"{tuple(dz.shape)}"
        )
    b, _, f, t, cin = x.shape
    cout = dz.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel K takes float32 or bfloat16, got {x.dtype}")
    if cin % 8 or cout % 8:
        raise ValueError(f"kernel K needs channel counts that are multiples of 8, got "
                         f"cin={cin} cout={cout}")
    _check_cuda_tensor("x", x, x.dtype, x.shape)
    _check_cuda_tensor("dz", dz, x.dtype, (b, 4, f, t, cout))
    if dz.device != x.device:
        raise ValueError(f"dz is on {dz.device}, x on {x.device}")
    if alpha is not None:
        _check_cuda_tensor("alpha", alpha, torch.float32, (4 * cin,))
        if alpha.device != x.device:
            raise ValueError(f"alpha is on {alpha.device}, x on {x.device}")
    lib = lib if lib is not None else _build.load_library()
    n_prods = scheme.n_prods
    xc = torch.empty((n_prods, b, f, t, cin), dtype=x.dtype, device=x.device)
    dzc = torch.empty((n_prods, b, f, t, cout), dtype=x.dtype, device=x.device)
    db = torch.empty(4 * cout, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return xc, dzc, db.zero_()
    blocks = lib.qasr_qconv_dw_prep_blocks(b, f, t)
    if blocks < 1:
        raise ValueError(f"kernel K does not take B*F*T = {b * f * t} rows")
    part = torch.empty((blocks, 4 * cout), dtype=torch.float32, device=x.device)
    v_tab, o_tab = _TABLES[scheme.name]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qasr_qconv_dw_prep(
            x.data_ptr(), None if alpha is None else alpha.data_ptr(), dz.data_ptr(),
            xc.data_ptr(), dzc.data_ptr(), part.data_ptr(), db.data_ptr(),
            b, f, t, cin, cout, n_prods, _DTYPE_CODE[x.dtype],
            v_tab.ctypes.data_as(ctypes.c_void_p),
            o_tab.ctypes.data_as(ctypes.c_void_p),
            stream,
        )
    _build.check(lib, err, "qconv_dw_prep launch")
    qconv_dw_prep.launches += 1
    return xc, dzc, db


def qconv_dw_prep(
    x: torch.Tensor,
    dz: torch.Tensor,
    alpha: torch.Tensor | None = None,
    *,
    scheme: _Scheme = SCHEME8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(xc, dzc, db)`` of the stacked conv's dW in ``scheme``: a CPU tensor
    takes the plain version, a CUDA tensor launches kernel K or raises."""
    if not x.is_cuda:
        return qconv_dw_prep_plain(x, dz, alpha, scheme=scheme)
    return qconv_dw_prep_cuda(
        x.contiguous(),
        dz.contiguous(),
        None if alpha is None else alpha.float().contiguous(),
        scheme=scheme,
    )


#: launches of kernel K since the last reset (counted where it launches; the
#: db reduction inside the same call is not counted apart)
qconv_dw_prep.launches = 0
