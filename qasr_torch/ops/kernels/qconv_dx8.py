"""The transposed rank-8 stacked quaternion conv of the backward: kernel C
(``qasr_torch/csrc/qconv_dx8.cu``) and its plain PyTorch version.

Counterpart of ``qasr/ops/pallas/qconv_chain.py:_dx_kernel`` (the transposed
conv with the previous layer's PReLU backward fused in) and of
``qasr/ops/pallas/qconv_ft.py:_ft_kernel`` in its dx role (``_ft_dx_impl``,
no PReLU). The adjoint of the SAME quaternion conv is a plain quaternion conv
with the conjugate weights, Cin and Cout swapped and both tap axes flipped
(:func:`conj_transpose_w`), so kernel C runs kernel A's main loop on those
weights and adds its own epilogue:

    g      = convT(dz)                      [B, 4, F, T, Cin]
    dx     = where(z_prev < 0, alpha * g, g)
    dalpha = sum over B, F, T of where(z_prev < 0, g * z_prev, 0)   (f32)

``z_prev`` is this layer's input, the previous layer's pre-activation, and
``alpha`` that layer's PReLU slopes; without them ``dx = g`` and there is no
``dalpha``. Its wrapper :func:`qconv_dx8` takes the plain version for a CPU
tensor only; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from qasr_torch.ops.kernels import _build
from qasr_torch.ops.kernels.qconv_ft import (
    _DTYPE_CODE,
    _O8_F32,
    _V8_F32,
    _check_cuda_tensor,
    qconv_fast8_stacked_plain,
    supported,
)
from qasr_torch.ops.quaternion import combine_weights


def conj_transpose_w(w: torch.Tensor) -> torch.Tensor:
    """``[4, kh, kw, Cin, Cout]`` -> the adjoint kernel ``[4, kh, kw, Cout, Cin]``:
    conjugate components, both tap axes flipped, channel dims swapped
    (after ``qasr/ops/pallas/qconv_ft.py:_conj_transpose_w``)."""
    wc = torch.cat([w[:1], -w[1:]], dim=0).flip(1, 2)
    return wc.transpose(-1, -2)


def _prelu_backward(g, z_prev, alpha):
    """(dx, dalpha) of the split PReLU at ``z_prev`` for the cotangent ``g``
    (both f32)."""
    c = z_prev.shape[-1]
    neg = z_prev < 0
    a = alpha.float().reshape(4, 1, 1, c)
    dalpha = torch.where(neg, g * z_prev, torch.zeros_like(g)).sum(dim=(0, 2, 3))
    return torch.where(neg, a * g, g), dalpha.reshape(-1)


def qconv_dx8_plain(
    dz: torch.Tensor,
    w: torch.Tensor,
    z_prev: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of kernel C: the plain rank-8 conv on the conj-transposed
    flipped weights, then the PReLU backward in f32. Returns
    ``(dx [B,4,F,T,Cin] in dz's dtype, dalpha [4*Cin] f32 or None)``."""
    g = qconv_fast8_stacked_plain(dz, conj_transpose_w(w))
    if z_prev is None:
        return g, None
    dx, dalpha = _prelu_backward(g.float(), z_prev.float(), alpha)
    return dx.to(dz.dtype), dalpha


def qconv_dx8_cuda(
    dz: torch.Tensor,
    wc: torch.Tensor,
    z_prev: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch kernel C. ``dz [B,4,F,T,Cout]`` and ``wc [8,kh,kw,Cout,Cin]``
    (the U8 combos of :func:`conj_transpose_w`) on one CUDA device,
    contiguous, both f32 or both bf16; ``z_prev [B,4,F,T,Cin]`` in dz's dtype
    and ``alpha [4*Cin]`` f32, or both None. Raises on anything the kernel
    does not take, or when it fails to build or launch."""
    if dz.ndim != 5 or dz.shape[1] != 4 or wc.ndim != 5 or wc.shape[0] != 8:
        raise ValueError(
            f"expected dz [B,4,F,T,C] and wc [8,kh,kw,Cout,Cin], got "
            f"{tuple(dz.shape)} and {tuple(wc.shape)}"
        )
    if (z_prev is None) != (alpha is None):
        raise ValueError("pass z_prev and alpha together, or neither")
    b, _, f, t, cout = dz.shape
    _, kh, kw, _, cin = wc.shape
    if dz.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel C takes float32 or bfloat16, got {dz.dtype}")
    if not supported(cout, cin, (kh, kw)):
        raise ValueError(f"kernel C does not support cin={cin} cout={cout} kernel={(kh, kw)}")
    _check_cuda_tensor("dz", dz, dz.dtype, dz.shape)
    _check_cuda_tensor("wc", wc, dz.dtype, (8, kh, kw, cout, cin))
    if wc.device != dz.device:
        raise ValueError(f"wc is on {wc.device}, dz on {dz.device}")
    if z_prev is not None:
        _check_cuda_tensor("z_prev", z_prev, dz.dtype, (b, 4, f, t, cin))
        _check_cuda_tensor("alpha", alpha, torch.float32, (4 * cin,))
        for name, v in (("z_prev", z_prev), ("alpha", alpha)):
            if v.device != dz.device:
                raise ValueError(f"{name} is on {v.device}, dz on {dz.device}")
    lib = _build.load_library()
    dx = torch.empty((b, 4, f, t, cin), dtype=dz.dtype, device=dz.device)
    dalpha = partials = None
    if z_prev is not None:
        dalpha = torch.empty(4 * cin, dtype=torch.float32, device=dz.device)
        rows = lib.qasr_qconv_dx8_partial_rows(b, f, t)
        partials = torch.empty((rows, 4 * cin), dtype=torch.float32, device=dz.device)
    if dx.numel() == 0:
        return dx, None if dalpha is None else dalpha.zero_()

    def ptr(v):
        return None if v is None else v.data_ptr()

    with torch.cuda.device(dz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qasr_qconv_dx8(
            dz.data_ptr(), wc.data_ptr(), ptr(z_prev), ptr(alpha), dx.data_ptr(),
            ptr(partials), ptr(dalpha), b, f, t, cout, cin, kh, kw,
            _DTYPE_CODE[dz.dtype],
            _V8_F32.ctypes.data_as(ctypes.c_void_p),
            _O8_F32.ctypes.data_as(ctypes.c_void_p),
            stream,
        )
    _build.check(lib, err, "qconv_dx8 launch")
    qconv_dx8.launches += 1
    return dx, dalpha


def qconv_dx8(
    dz: torch.Tensor,
    w: torch.Tensor,
    z_prev: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The backward of ``z = qconv8(prelu_alpha(z_prev), w) + bias`` with
    respect to the conv's input: ``(dx, dalpha)``.

    ``dz [B,4,F,T,Cout]`` in the compute dtype; ``w [4,kh,kw,Cin,Cout]`` (the
    forward's weights, checkpoint layout); ``z_prev [B,4,F,T,Cin]`` and
    ``alpha [4*Cin]`` for the fused PReLU backward, or None (then
    ``dalpha`` is None). A CPU tensor takes the plain version; a CUDA tensor
    launches kernel C or raises.
    """
    if not dz.is_cuda:
        return qconv_dx8_plain(dz, w, z_prev, alpha)
    wc = combine_weights(conj_transpose_w(w), dz.dtype).contiguous()
    return qconv_dx8_cuda(
        dz.contiguous(),
        wc,
        None if z_prev is None else z_prev.contiguous(),
        None if alpha is None else alpha.float().contiguous(),
    )


#: launches of kernel C since the last reset (counted where it launches; the
#: dalpha reduction inside the same call is not counted apart)
qconv_dx8.launches = 0
