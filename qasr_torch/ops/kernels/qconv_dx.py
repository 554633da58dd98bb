"""The transposed stacked quaternion conv of the backward: kernel C
(``qasr_torch/csrc/qconv_dx8.cu``, the rank-8 scheme), kernel G
(``qasr_torch/csrc/qconv_dx10.cu``, the 10-product scheme) and their plain
PyTorch version.

Counterpart of ``qasr/ops/pallas/qconv_chain.py:_dx_kernel`` (the transposed
conv with the previous layer's PReLU backward fused in) and of
``qasr/ops/pallas/qconv_ft.py:_ft_kernel`` in its dx role (``_ft_dx_impl``,
no PReLU), in either scheme. The adjoint of the SAME quaternion conv is a
plain quaternion conv with the conjugate weights, Cin and Cout swapped and
both tap axes flipped (:func:`conj_transpose_w`), so kernels C and G run the
forward kernels' main loop (A's and F's) on those weights and add their own
epilogue:

    g      = convT(dz)                      [B, 4, F, T, Cin]
    dx     = where(z_prev < 0, alpha * g, g)
    dalpha = sum over B, F, T of where(z_prev < 0, g * z_prev, 0)   (f32)

``z_prev`` is this layer's input, the previous layer's pre-activation, and
``alpha`` that layer's PReLU slopes; without them ``dx = g`` and there is no
``dalpha``. The wrappers :func:`qconv_dx8` and :func:`qconv_dx10` take the
plain version for a CPU tensor only; for a CUDA tensor they launch the
kernel or raise. The TPU's dx role rotated the scheme's roles instead
(:func:`qconv_dx10_rotated_plain`); it computes the same transposed conv.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from qasr_torch.ops.kernels import _build
from qasr_torch.ops.kernels.qconv_ft import (
    _DTYPE_CODE,
    _TABLES,
    SCHEME8,
    SCHEME10,
    _check_cuda_tensor,
    _combo,
    _Scheme,
    qconv_stacked_plain,
    supported,
)
from qasr_torch.ops.quaternion import combine_weights, device_table


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


def qconv_dx_plain(
    dz: torch.Tensor,
    w: torch.Tensor,
    z_prev: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
    *,
    scheme: _Scheme = SCHEME8,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of kernels C and G: the plain conv in ``scheme`` on the
    conj-transposed flipped weights, then the PReLU backward in f32. Returns
    ``(dx [B,4,F,T,Cin] in dz's dtype, dalpha [4*Cin] f32 or None)``."""
    g = qconv_stacked_plain(dz, conj_transpose_w(w), scheme=scheme)
    if z_prev is None:
        return g, None
    dx, dalpha = _prelu_backward(g.float(), z_prev.float(), alpha)
    return dx.to(dz.dtype), dalpha


def qconv_dx10_rotated_plain(dz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The transposed 10-product conv as the TPU's dx role formed it
    (``qconv_ft.py:_ft_dx_impl`` with ``SCHEME10``): input combos from
    OUT_COMBO's columns (signed, term by term in dz's dtype), the W_COMBO
    weights flipped over both tap axes with Cin and Cout swapped (not
    conjugated), the output recombined from X_COMBO's columns in f32. The
    same function as :func:`qconv_dx_plain` in ``SCHEME10`` without the PReLU; a second
    reference for kernel G."""
    _, kh, kw, _, _ = w.shape
    sc = SCHEME10
    # [P, kh, kw, Cin, Cout], taps flipped -> per product [Cin, Cout, kw (F), kh (T)]
    wc = combine_weights(w, dz.dtype, sc.u).flip(1, 2).permute(0, 3, 4, 2, 1)
    pad = ((kw - 1) // 2, (kh - 1) // 2)
    prods = []
    for p, terms in enumerate(sc.dx_in):
        dzc = _combo(dz, terms)  # [B, F, T, Cout]
        prods.append(F.conv2d(dzc.permute(0, 3, 1, 2), wc[p], padding=pad).float())
    v = device_table(sc.v_mat, torch.float32, dz.device)
    return torch.einsum("pbnft,pa->baftn", torch.stack(prods), v).to(dz.dtype)


# per scheme: the kernel's letter and its C entry
_DX_KERNELS = {"fast8": ("C", "qasr_qconv_dx8"), "fast10": ("G", "qasr_qconv_dx10")}


def qconv_dx_cuda(
    dz: torch.Tensor,
    wc: torch.Tensor,
    z_prev: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
    *,
    scheme: _Scheme = SCHEME8,
    lib=None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch kernel C (``SCHEME8``) or G (``SCHEME10``). ``dz
    [B,4,F,T,Cout]`` and ``wc [P,kh,kw,Cout,Cin]`` (the scheme's weight
    combos of :func:`conj_transpose_w`) on one CUDA device, contiguous, both
    f32 or both bf16; ``z_prev [B,4,F,T,Cin]`` in dz's dtype and ``alpha
    [4*Cin]`` f32, or both None; ``lib`` as :func:`qconv_ft_cuda`'s. Raises
    on anything the kernel does not take, or when it fails to build or
    launch."""
    letter, entry = _DX_KERNELS[scheme.name]
    n_prods = scheme.n_prods
    if dz.ndim != 5 or dz.shape[1] != 4 or wc.ndim != 5 or wc.shape[0] != n_prods:
        raise ValueError(
            f"expected dz [B,4,F,T,C] and wc [{n_prods},kh,kw,Cout,Cin], got "
            f"{tuple(dz.shape)} and {tuple(wc.shape)}"
        )
    if (z_prev is None) != (alpha is None):
        raise ValueError("pass z_prev and alpha together, or neither")
    b, _, f, t, cout = dz.shape
    _, kh, kw, _, cin = wc.shape
    if dz.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel {letter} takes float32 or bfloat16, got {dz.dtype}")
    if not supported(cout, cin, (kh, kw)):
        raise ValueError(
            f"kernel {letter} does not support cin={cin} cout={cout} kernel={(kh, kw)}"
        )
    _check_cuda_tensor("dz", dz, dz.dtype, dz.shape)
    _check_cuda_tensor("wc", wc, dz.dtype, (n_prods, kh, kw, cout, cin))
    if wc.device != dz.device:
        raise ValueError(f"wc is on {wc.device}, dz on {dz.device}")
    if z_prev is not None:
        _check_cuda_tensor("z_prev", z_prev, dz.dtype, (b, 4, f, t, cin))
        _check_cuda_tensor("alpha", alpha, torch.float32, (4 * cin,))
        for name, v in (("z_prev", z_prev), ("alpha", alpha)):
            if v.device != dz.device:
                raise ValueError(f"{name} is on {v.device}, dz on {dz.device}")
    lib = lib if lib is not None else _build.load_library()
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

    v_tab, o_tab = _TABLES[scheme.name]
    with torch.cuda.device(dz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            dz.data_ptr(), wc.data_ptr(), ptr(z_prev), ptr(alpha), dx.data_ptr(),
            ptr(partials), ptr(dalpha), b, f, t, cout, cin, kh, kw,
            _DTYPE_CODE[dz.dtype],
            v_tab.ctypes.data_as(ctypes.c_void_p),
            o_tab.ctypes.data_as(ctypes.c_void_p),
            stream,
        )
    _build.check(lib, err, f"{entry[5:]} launch")
    _WRAPPERS[scheme.name].launches += 1
    return dx, dalpha


def _qconv_dx(dz, w, z_prev, alpha, scheme: _Scheme):
    if not dz.is_cuda:
        return qconv_dx_plain(dz, w, z_prev, alpha, scheme=scheme)
    wc = combine_weights(conj_transpose_w(w), dz.dtype, scheme.u).contiguous()
    return qconv_dx_cuda(
        dz.contiguous(),
        wc,
        None if z_prev is None else z_prev.contiguous(),
        None if alpha is None else alpha.float().contiguous(),
        scheme=scheme,
    )


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
    return _qconv_dx(dz, w, z_prev, alpha, SCHEME8)


def qconv_dx10(
    dz: torch.Tensor,
    w: torch.Tensor,
    z_prev: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`qconv_dx8` for the 10-product conv: kernel G on a CUDA
    tensor."""
    return _qconv_dx(dz, w, z_prev, alpha, SCHEME10)


#: launches of kernels C and G since the last reset (counted where each
#: launches; the dalpha reduction inside the same call is not counted apart)
qconv_dx8.launches = 0
qconv_dx10.launches = 0
_WRAPPERS = {"fast8": qconv_dx8, "fast10": qconv_dx10}
