"""Rank-8 quaternion GEMM: kernel B (``qasr_torch/csrc/qgemm8.cu``), its
plain PyTorch version, and its gradient.

Counterpart of ``qasr/ops/pallas/qgemm8.py``: the TPU kernel
``_qgemm8_kernel`` becomes a hand-written CUDA kernel for Hopper
(``csrc/qgemm.cuh``) in which warp p forms product p's 2-sparse V8 input
combos in registers from each staged input chunk, accumulates it in f32
over the whole contraction and the eight products are recombined with O8
once at the end. Layout: component-leading ``x4 [4, M, K]`` -> ``y4 [4, M, N]``;
``qdense_pallas8`` wraps it for the packed ``[..., 4K]`` layout.

:class:`QGemm8Fn` is the counterpart of ``qgemm8_cl``'s custom VJP. Its dx
role runs kernel B again, on the U8 combos of the conjugate-transposed
weights: the adjoint of quaternion left-multiplication is multiplication by
the conjugate, so ``dx4 = qgemm8(dy4, conj(w)^T)`` (the TPU kernel formed
dense O8-column combos instead; both give the same dx). dW is plain PyTorch
with the reference's two formulations, as the JAX package left it to XLA.

Every product is summed and kept in f32 until the fold, as the reference's
``preferred_element_type=f32`` dots keep it: the plain version, dW and
``qdense_fast8`` multiply bf16 operands into an f32 result (:func:`f32_bmm`),
never into bf16.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from qasr_torch.ops.kernels import _build
from qasr_torch.ops.kernels.qconv_ft import (
    _DTYPE_CODE,
    _O8_F32,
    _V8_F32,
    SCHEME8,
    _check_cuda_tensor,
    _combo,
)
from qasr_torch.ops.quaternion import HAMILTON_E, O8, O8_T, U8, V8, combine_weights, device_table


def combos8(x4: torch.Tensor) -> torch.Tensor:
    """The eight V8 input combos ``[8, M, K]`` of ``x4 [4, M, K]``, each
    formed term by term in x's dtype as ``_qgemm8_kernel`` forms them
    (``qasr/ops/pallas/qgemm8.py:_scaled``)."""
    return torch.stack([_combo(x4, terms, dim=0) for terms in SCHEME8.fwd_in])


def f32_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` with the products summed in f32 and returned in
    f32, whatever a's and b's dtype (bf16 values are exact in f32): on the
    card a bf16 pair takes cuBLAS's bf16 GEMM with an f32 output, anywhere
    else the operands are upcast. No autograd formula: under grad, upcast
    the operands instead."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def qgemm8_cl_plain(x4: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B: ``qdense_fast8`` on ``[4, M, K]`` with ``w
    [4, K, N]``; the input and weight combos in x's dtype (:func:`combos8`,
    ``combine_weights``), their products summed in f32, the O8 recombination
    in f32 and one rounding to x's dtype at the end."""
    xc = combos8(x4)
    # f32 operands, not f32_bmm: the plain version runs under autograd
    prods = torch.bmm(xc.float(), combine_weights(w, x4.dtype).float())  # [8, M, N]
    o8 = device_table(O8, torch.float32, x4.device)
    return torch.einsum("pmn,bp->bmn", prods, o8).to(x4.dtype)


def qgemm8_cuda(x4: torch.Tensor, wc8: torch.Tensor, *, role: str = "fwd",
                lib=None) -> torch.Tensor:
    """Launch kernel B on ``x4 [4, M, K]`` and U8-combined ``wc8 [8, K, N]``:
    one CUDA device, contiguous, both f32 or both bf16, K and N multiples of
    8. ``role`` ("fwd" or "dx") names the counter the launch adds to;
    ``lib`` a kernel library other than the package's (a variant built by
    ``qasr_torch.tools.ablate_qgemm``). Raises on anything the kernel does
    not take, or when it fails to build or launch."""
    if x4.ndim != 3 or x4.shape[0] != 4 or wc8.ndim != 3 or wc8.shape[0] != 8:
        raise ValueError(
            f"expected x4 [4,M,K] and wc8 [8,K,N], got {tuple(x4.shape)} and "
            f"{tuple(wc8.shape)}"
        )
    _, m, k = x4.shape
    n = wc8.shape[2]
    if x4.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel B takes float32 or bfloat16, got {x4.dtype}")
    if k % 8 or n % 8:
        raise ValueError(f"kernel B needs K and N multiples of 8, got K={k} N={n}")
    _check_cuda_tensor("x4", x4, x4.dtype, x4.shape)
    _check_cuda_tensor("wc8", wc8, x4.dtype, (8, k, n))
    if wc8.device != x4.device:
        raise ValueError(f"wc8 is on {wc8.device}, x4 on {x4.device}")
    lib = lib if lib is not None else _build.load_library()
    y4 = torch.empty((4, m, n), dtype=x4.dtype, device=x4.device)
    if y4.numel() == 0:
        return y4
    with torch.cuda.device(x4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qasr_qgemm8(
            x4.data_ptr(), wc8.data_ptr(), y4.data_ptr(), m, k, n,
            _DTYPE_CODE[x4.dtype],
            _V8_F32.ctypes.data_as(ctypes.c_void_p),
            _O8_F32.ctypes.data_as(ctypes.c_void_p),
            stream,
        )
    _build.check(lib, err, "qgemm8 launch")
    if role == "dx":
        qgemm8_dx.launches += 1
    else:
        qgemm8_cl.launches += 1
    return y4


def _qgemm8_padded(x4: torch.Tensor, w: torch.Tensor, role: str) -> torch.Tensor:
    """Kernel B on ``x4 [4, M, K]`` (CUDA) and ``w [4, K, N]``; ragged K and N
    are zero-padded to multiples of 8 here, ragged M is masked in the
    kernel."""
    k, n = w.shape[1], w.shape[2]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    wc8 = combine_weights(w, x4.dtype)
    if (kp, np_) != (k, n):
        x4 = F.pad(x4, (0, kp - k))
        wc8 = F.pad(wc8, (0, np_ - n, 0, kp - k))
    y4 = qgemm8_cuda(x4.contiguous(), wc8.contiguous(), role=role)
    return y4[:, :, :n] if np_ != n else y4


def conj_transpose_dense(w: torch.Tensor) -> torch.Tensor:
    """``[4, K, N]`` -> the adjoint weights ``[4, N, K]``: conjugate
    components, K and N swapped (after ``qasr/ops/pallas/qgemm.py:_conj_transpose_w``)."""
    return torch.cat([w[:1], -w[1:]], dim=0).transpose(1, 2)


def qgemm8_dx(dy4: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx role: ``dy4 [4, M, N]`` -> ``dx4 [4, M, K]`` for the forward weights
    ``w [4, K, N]``. A CPU tensor takes the plain version; a CUDA tensor
    launches kernel B on the conj-transposed weights (counted in
    ``qgemm8_dx.launches``) or raises."""
    wt = conj_transpose_dense(w)
    if not dy4.is_cuda:
        return qgemm8_cl_plain(dy4, wt)
    return _qgemm8_padded(dy4, wt, "dx")


def qgemm8_dw(x4: torch.Tensor, dy4: torch.Tensor) -> torch.Tensor:
    """dW ``[4, K, N]`` f32 of the rank-8 GEMM, after ``qgemm8.py:240-259``.

    Large ``K*N`` (>= 2**20): the rank-8 form, 8 GEMMs on the V8 input and
    O8 output combos folded back with U8. Otherwise one block product
    ``[4, K, 4, N]`` folded with the Hamilton table. Combos in the compute
    dtype, products summed in f32 (:func:`f32_bmm`), folds in f32.
    """
    m, k, n = x4.shape[1], x4.shape[2], dy4.shape[2]
    if k * n >= 1 << 20:
        xc = torch.einsum("amk,pa->pmk", x4, device_table(V8, x4.dtype, x4.device))
        o8t = device_table(O8_T, dy4.dtype, dy4.device)
        dyc = torch.einsum("bmn,pb->pmn", dy4, o8t)
        dwc8 = f32_bmm(xc.transpose(1, 2), dyc)  # [8, K, N]
        u8 = device_table(U8, torch.float32, x4.device)
        return torch.einsum("pkn,pa->akn", dwc8, u8)
    # [4K, M] @ [M, 4N]: every (a, k) x (b, n) product of the block form
    xt = x4.transpose(1, 2).reshape(1, 4 * k, m)
    dyt = dy4.transpose(0, 1).reshape(1, m, 4 * n)
    dw_big = f32_bmm(xt, dyt).reshape(4, k, 4, n)
    e = device_table(HAMILTON_E, torch.float32, x4.device)
    return torch.einsum("akbn,cab->ckn", dw_big, e)


class QGemm8Fn(torch.autograd.Function):
    """``y4 = qgemm8(x4, w)``: kernel B forward, kernel B on the
    conj-transposed weights for dx, :func:`qgemm8_dw` for dW (in ``w``'s
    dtype)."""

    @staticmethod
    def forward(ctx, x4, w):
        ctx.save_for_backward(x4, w)
        if not x4.is_cuda:
            return qgemm8_cl_plain(x4, w)
        return _qgemm8_padded(x4, w, "fwd")

    @staticmethod
    def backward(ctx, dy4):
        x4, w = ctx.saved_tensors
        dy4 = dy4.contiguous()
        dx4 = qgemm8_dx(dy4, w) if ctx.needs_input_grad[0] else None
        return dx4, qgemm8_dw(x4, dy4).to(w.dtype)


def qgemm8_cl(x4: torch.Tensor, w: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Component-leading rank-8 quaternion GEMM: ``x4 [4, M, K]`` with stacked
    weights ``w [4, K, N]`` -> ``[4, M, N]`` in x's dtype.

    A CPU tensor (or ``plain=True``) takes the plain version under autograd;
    a CUDA tensor goes through :class:`QGemm8Fn` (kernel B forward and dx) or
    raises.
    """
    if w.ndim != 3 or w.shape[0] != 4 or w.shape[1] != x4.shape[-1]:
        raise ValueError(f"weights {tuple(w.shape)} incompatible with x4 {tuple(x4.shape)}")
    if plain or not x4.is_cuda:
        return qgemm8_cl_plain(x4, w)
    return QGemm8Fn.apply(x4.contiguous(), w)


#: launches of kernel B in its forward role since the last reset (counted
#: where it launches)
qgemm8_cl.launches = 0
#: launches of kernel B in its dx role since the last reset
qgemm8_dx.launches = 0


def qdense_pallas8(x: torch.Tensor, w: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Packed-layout wrapper: ``[..., 4K] x [4, K, N] -> [..., 4N]`` through
    the component-leading GEMM (one transpose in, one out)."""
    *lead, c4 = x.shape
    k = c4 // 4
    if c4 % 4 or w.shape[:2] != (4, k):
        raise ValueError(f"weights {tuple(w.shape)} incompatible with x {tuple(x.shape)}")
    m = x.numel() // c4
    x4 = x.reshape(m, 4, k).transpose(0, 1)
    y4 = qgemm8_cl(x4, w, plain=plain)
    return y4.transpose(0, 1).reshape(*lead, 4 * w.shape[2])
