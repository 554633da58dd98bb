"""Stacked quaternion conv2d on the component-stacked, frequency-major
layout: kernel A (``qasr_torch/csrc/qconv_ft8.cu``, the rank-8 scheme),
kernel F (``qasr_torch/csrc/qconv_ft10.cu``, the 10-product scheme) and their
plain PyTorch version.

Counterpart of ``qasr/ops/pallas/qconv_ft.py``: the TPU kernel ``_ft_kernel``
(forward role, with either scheme) becomes hand-written CUDA kernels for
Hopper on the main loops of ``csrc/qconv.cuh`` (P = 8 and P = 10
products; kernel F in bf16 on its TMA + wgmma loop), and
``_qconv_stacked_xla`` (P plain convs on the input combos) becomes the
plain version the CPU path and the card's parity checks use.

Layout: ``x [B, 4, F, T, C]`` (component slices lead; F-major), weights
``w [4, kh, kw, Cin, Cout]`` with kh over time and kw over frequency — the
stacked layout is (F, T)-major, so the plain version swaps the two kernel
dims for ``F.conv2d`` (H = F, W = T), and the kernels index tap
``s = dt*kw + df`` exactly as ``_ft_kernel`` does.

Kernels A and F compute, per layer, ``bias + qconv(act(x))`` where ``act``
is the previous layer's split PReLU (``alpha``) or the identity; bias and
alpha are optional. Their wrappers :func:`qconv_ft8` and :func:`qconv_ft10`
take the plain version for a CPU tensor only; for a CUDA tensor they launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from qasr_torch.ops.kernels import _build
from qasr_torch.ops.quaternion import (
    O8,
    OUT_COMBO,
    U8,
    V8,
    W_COMBO,
    X_COMBO,
    combine_weights,
    device_table,
)


class _Scheme:
    """A bilinear decomposition of the Hamilton product:
    ``y_b = Σ_p O[b,p] · (Σ_a U[p,a] w_a) ⊛ (Σ_a V[p,a] x_a)``, with its
    sparse term tables ((index, coefficient) tuples)."""

    def __init__(self, name, u, v, o):
        self.name = name
        self.u = np.asarray(u, np.float64)   # [P, 4] weight side
        v = np.asarray(v, np.float64)        # [P, 4] input side
        o = np.asarray(o, np.float64)        # [4, P] output side
        p = self.u.shape[0]
        self.n_prods = p
        self.fwd_in = tuple(
            tuple((int(a), float(v[q, a])) for a in range(4) if v[q, a] != 0)
            for q in range(p)
        )
        self.fwd_out = tuple(
            tuple((int(b), float(o[b, q])) for b in range(4) if o[b, q] != 0)
            for q in range(p)
        )
        self.dx_in = self.fwd_out
        self.dx_out = self.fwd_in
        self.v_mat = v.copy()
        self.o_mat = o.copy()


SCHEME10 = _Scheme("fast10", W_COMBO, X_COMBO, OUT_COMBO)
SCHEME8 = _Scheme("fast8", U8, V8, O8)
SCHEMES = {"fast8": SCHEME8, "fast10": SCHEME10}

# f32 tables handed to the kernels (host memory, read at launch): the input
# side [P, 4] and the output side [4, P] of each scheme
_TABLES = {
    name: (np.ascontiguousarray(sc.v_mat, np.float32), np.ascontiguousarray(sc.o_mat, np.float32))
    for name, sc in SCHEMES.items()
}
_V8_F32, _O8_F32 = _TABLES["fast8"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Largest kernel height and width: a 5x5 tile fits a block's shared memory in
# both dtypes; 7 does not (the launcher checks the exact size and raises).
_MAX_KERNEL = 5


def supported(cin: int, cout: int, kernel_size, padding="SAME", strides=None) -> bool:
    """Whether kernels A and F handle this conv: stride 1, SAME, odd kernels
    of at most 5x5, and channel counts that are multiples of 8 (one 16-byte
    bf16 vector)."""
    kh, kw = kernel_size
    return (
        padding == "SAME"
        and (strides is None or tuple(strides) == (1, 1))
        and kh % 2 == 1
        and kw % 2 == 1
        and kh <= _MAX_KERNEL
        and kw <= _MAX_KERNEL
        and cin % 8 == 0
        and cout % 8 == 0
    )


def pack_to_stacked(x_ft: torch.Tensor) -> torch.Tensor:
    """[B, F, T, 4C] packed -> [B, 4, F, T, C] stacked (a view; call
    ``.contiguous()`` where the layout must be materialised)."""
    b, f, t, c4 = x_ft.shape
    return x_ft.reshape(b, f, t, 4, c4 // 4).movedim(3, 1)


def stacked_to_pack(x_st: torch.Tensor) -> torch.Tensor:
    """[B, 4, F, T, C] stacked -> [B, F, T, 4C] packed."""
    b, _, f, t, cq = x_st.shape
    return x_st.movedim(1, 3).reshape(b, f, t, 4 * cq)


def _prelu_stacked(x_st: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a = alpha.to(x_st.dtype).reshape(4, 1, 1, x_st.shape[-1])
    return torch.where(x_st >= 0, x_st, a * x_st)


@functools.lru_cache(maxsize=None)
def _coef(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as the JAX package's ``_scaled`` rounds a
    coefficient (``val.dtype.type(coef)``)."""
    return torch.tensor(c, dtype=dtype).item()


def _combo(x: torch.Tensor, terms, dim: int = 1) -> torch.Tensor:
    """``sum_a c_a * x.select(dim, a)`` over a scheme's (index, coefficient)
    terms, in the storage dtype as ``qasr/ops/pallas/qconv_ft.py:_scaled``
    forms it: each coefficient rounded to x's dtype, each scaled term
    rounded once, then the terms added, rounded once."""
    out = None
    for a, c in terms:
        t = x.select(dim, a) * _coef(c, x.dtype)
        out = t if out is None else out + t
    return out


def qconv_stacked_plain(
    x_st: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
    *,
    scheme: _Scheme = SCHEME8,
    padding: str = "SAME",
) -> torch.Tensor:
    """Plain version of kernels A and F: ``bias + qconv(act(x_st))`` in
    ``scheme``.

    P ``F.conv2d`` calls on the input combos (after ``_qconv_stacked_xla``),
    formed in x's dtype, on the weight combos ``combine_weights(w, dtype,
    scheme.u)``, recombined with the scheme's output table in f32.
    ``x_st [B,4,F,T,Cin]`` in the compute dtype; ``w [4,kh,kw,Cin,Cout]``;
    ``bias [4*Cout]`` and ``alpha [4*Cin]`` optional; ``padding`` "SAME"
    (odd kernels; the kernels' case) or "VALID". Returns
    ``[B,4,F',T',Cout]`` in x's dtype.
    """
    _, kh, kw, _, cout = w.shape
    if padding == "SAME":
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError(f"the stacked SAME conv needs odd kernels, got {(kh, kw)}")
        pad = ((kw - 1) // 2, (kh - 1) // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    if alpha is not None:
        x_st = _prelu_stacked(x_st, alpha)
    # [P, kh, kw, Cin, Cout] -> per product [Cout, Cin, kw (F), kh (T)]
    wc = combine_weights(w, x_st.dtype, scheme.u).permute(0, 4, 3, 2, 1)
    prods = []
    for p, terms in enumerate(scheme.fwd_in):
        xc = _combo(x_st, terms)  # [B, F, T, Cin]
        y = F.conv2d(xc.permute(0, 3, 1, 2), wc[p], padding=pad)  # [B, Cout, F, T]
        prods.append(y.float())
    o = device_table(scheme.o_mat, torch.float32, x_st.device)
    out = torch.einsum("pbnft,qp->bqftn", torch.stack(prods), o)
    if bias is not None:
        out = out + bias.float().reshape(4, 1, 1, cout)
    return out.to(x_st.dtype)


def _check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


# per scheme: the kernel's letter and its C entry
_FWD_KERNELS = {"fast8": ("A", "qasr_qconv_ft8"), "fast10": ("F", "qasr_qconv_ft10")}


def qconv_ft_cuda(
    x_st: torch.Tensor,
    wc: torch.Tensor,
    bias: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
    *,
    scheme: _Scheme = SCHEME8,
    lib=None,
) -> torch.Tensor:
    """Launch kernel A (``SCHEME8``) or F (``SCHEME10``). ``x_st
    [B,4,F,T,Cin]`` and ``wc [P,kh,kw,Cin,Cout]`` (the scheme's weight
    combos) on one CUDA device, contiguous, both f32 or both bf16; ``bias
    [4*Cout]`` / ``alpha [4*Cin]`` f32 or None; ``lib`` a kernel library
    other than the package's (a variant built by
    ``qasr_torch.tools.ablate_qconv``). Raises on anything the kernel does
    not take, or when it fails to build or launch."""
    letter, entry = _FWD_KERNELS[scheme.name]
    n_prods = scheme.n_prods
    if x_st.ndim != 5 or x_st.shape[1] != 4 or wc.ndim != 5 or wc.shape[0] != n_prods:
        raise ValueError(
            f"expected x [B,4,F,T,C] and wc [{n_prods},kh,kw,Cin,Cout], got "
            f"{tuple(x_st.shape)} and {tuple(wc.shape)}"
        )
    b, _, f, t, cin = x_st.shape
    _, kh, kw, _, cout = wc.shape
    if x_st.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel {letter} takes float32 or bfloat16, got {x_st.dtype}")
    if not supported(cin, cout, (kh, kw)):
        raise ValueError(
            f"kernel {letter} does not support cin={cin} cout={cout} kernel={(kh, kw)}"
        )
    _check_cuda_tensor("x_st", x_st, x_st.dtype, x_st.shape)
    _check_cuda_tensor("wc", wc, x_st.dtype, (n_prods, kh, kw, cin, cout))
    for name, v, n in (("bias", bias, 4 * cout), ("alpha", alpha, 4 * cin)):
        if v is not None:
            _check_cuda_tensor(name, v, torch.float32, (n,))
            if v.device != x_st.device:
                raise ValueError(f"{name} is on {v.device}, x on {x_st.device}")
    if wc.device != x_st.device:
        raise ValueError(f"wc is on {wc.device}, x on {x_st.device}")
    lib = lib if lib is not None else _build.load_library()
    out = torch.empty((b, 4, f, t, cout), dtype=x_st.dtype, device=x_st.device)
    if out.numel() == 0:
        return out
    v_tab, o_tab = _TABLES[scheme.name]
    with torch.cuda.device(x_st.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            x_st.data_ptr(), wc.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if alpha is None else alpha.data_ptr(),
            out.data_ptr(), b, f, t, cin, cout, kh, kw, _DTYPE_CODE[x_st.dtype],
            v_tab.ctypes.data_as(ctypes.c_void_p),
            o_tab.ctypes.data_as(ctypes.c_void_p),
            stream,
        )
    _build.check(lib, err, f"{entry[5:]} launch")
    _WRAPPERS[scheme.name].launches += 1
    return out


def _qconv_ft(x_st, w, bias, alpha, scheme: _Scheme) -> torch.Tensor:
    if not x_st.is_cuda:
        return qconv_stacked_plain(x_st, w, bias, alpha, scheme=scheme)
    return qconv_ft_cuda(
        x_st,
        combine_weights(w, x_st.dtype, scheme.u).contiguous(),
        None if bias is None else bias.float().contiguous(),
        None if alpha is None else alpha.float().contiguous(),
        scheme=scheme,
    )


def qconv_ft8(
    x_st: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rank-8 stacked quaternion conv ``bias + qconv8(act(x_st))``.

    ``x_st [B,4,F,T,Cin]`` in the compute dtype; ``w [4,kh,kw,Cin,Cout]``
    (stacked checkpoint layout); ``bias [4*Cout]`` and ``alpha [4*Cin]`` (the
    previous layer's PReLU slopes) optional. A CPU tensor takes the plain
    version; a CUDA tensor launches kernel A or raises.
    """
    return _qconv_ft(x_st, w, bias, alpha, SCHEME8)


def qconv_ft10(
    x_st: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
) -> torch.Tensor:
    """The 10-product stacked quaternion conv ``bias + qconv10(act(x_st))``:
    as :func:`qconv_ft8`, through kernel F on a CUDA tensor."""
    return _qconv_ft(x_st, w, bias, alpha, SCHEME10)


#: launches of kernels A and F since the last reset (counted where each
#: launches)
qconv_ft8.launches = 0
qconv_ft10.launches = 0
_WRAPPERS = {"fast8": qconv_ft8, "fast10": qconv_ft10}


def qconv_fast8_stacked(x_st: torch.Tensor, w: torch.Tensor, *, padding: str = "SAME") -> torch.Tensor:
    """The rank-8 quaternion conv on the stacked F-major layout
    (``qasr/ops/pallas/qconv_ft.py:qconv_fast8_stacked``, the JAX package's
    XLA arm): :func:`qconv_stacked_plain` in ``SCHEME8``, differentiable by
    autograd (P cuDNN convs and their adjoints; no kernel of the port)."""
    return qconv_stacked_plain(x_st, w, scheme=SCHEME8, padding=padding)


def qconv_fast10_stacked(x_st: torch.Tensor, w: torch.Tensor, *, padding: str = "SAME") -> torch.Tensor:
    """The 10-product quaternion conv on the stacked F-major layout
    (``qasr/ops/pallas/qconv_ft.py:qconv_fast10_stacked``), as
    :func:`qconv_fast8_stacked` in ``SCHEME10``."""
    return qconv_stacked_plain(x_st, w, scheme=SCHEME10, padding=padding)
