"""The 10-product quaternion GEMM: kernel H (``qasr_torch/csrc/qgemm10.cu``,
forward and dx), kernel I (``qasr_torch/csrc/qgemm10_dw.cu``, dW), their
plain PyTorch versions, the autograd function and the dense and im2col-conv
wrappers.

Counterpart of ``qasr/ops/pallas/qgemm.py``: the TPU kernels
``_qgemm_kernel`` and ``_qgemm_dw_kernel`` become hand-written CUDA kernels
for Hopper. Layout: component-leading ``x4 [4, M, K]`` -> ``y4 [4, M, N]``
with stacked weights ``w [4, K, N]``; :func:`qdense_pallas` and
:func:`qconv2d_pallas` wrap it for the packed ``[..., 4K]`` layout.

:class:`QGemmFn` is the counterpart of ``qgemm_stacked``'s custom VJP
(``qgemm.py:295-317``): forward kernel H; dx kernel H again, on the
conjugate-transposed weights (the adjoint of quaternion left-multiplication
is multiplication by the conjugate); dW kernel I when the contraction M is
at least 256, else the 16-product einsum :func:`dw_einsum`, as the TPU
routed it. Rounding as the TPU kernels': the combos in the storage dtype,
the products accumulated in f32, the recombination and the dW scatter in
f32, one cast at the end.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from qasr_torch.ops.kernels import _build
from qasr_torch.ops.kernels.dgt import splits
from qasr_torch.ops.kernels.qconv_ft import _DTYPE_CODE, _TABLES, _check_cuda_tensor
from qasr_torch.ops.kernels.qgemm8 import conj_transpose_dense
from qasr_torch.ops.quaternion import (
    HAMILTON_E,
    OUT_COMBO,
    W_COMBO,
    X_COMBO,
    combine_weights,
    device_table,
)

#: the contraction length from which dW runs kernel I (``qgemm.py:310``)
DW_KERNEL_MIN_M = 256
# kernel I's rows of M a chunk, its (K, N) output tile and its blocks
# resident on an SM (qgemm10_dw.cu: DwCfg, BM x BN, kMinBlocks): the split
# of M aims at one full wave of them
_DW_CHUNK = {torch.bfloat16: 64, torch.float32: 16}
_DW_TILE = (64, 64)
_DW_BLOCKS_PER_SM = 1

# each product's input terms (X_COMBO row) and cotangent terms (OUT_COMBO
# column, b ascending), as qgemm.py's _X_TERMS and _OUT_TERMS_OF_P
_X_TERMS = [tuple(int(a) for a in np.nonzero(X_COMBO[p])[0]) for p in range(10)]
_OUT_TERMS_OF_P = [
    [(b, int(OUT_COMBO[b, p])) for b in range(4) if OUT_COMBO[b, p] != 0] for p in range(10)
]
_W_COMBO_F32 = np.ascontiguousarray(W_COMBO, np.float32)


def _x_combos(x4: torch.Tensor) -> torch.Tensor:
    """``[10, M, K]``: X_COMBO's one- or two-term sums of x4's components, in
    x4's dtype (``_qgemm_kernel``'s ``lhs``)."""
    out = []
    for terms in _X_TERMS:
        c = x4[terms[0]]
        if len(terms) == 2:
            c = c + x4[terms[1]]
        out.append(c)
    return torch.stack(out)


def _dy_combos(dy4: torch.Tensor) -> torch.Tensor:
    """``[10, M, N]``: OUT_COMBO's signed column sums of dy4's components,
    term by term in dy4's dtype (``_qgemm_dw_kernel``'s ``rhs``)."""
    out = []
    for terms in _OUT_TERMS_OF_P:
        (b0, s0), *rest = terms
        c = dy4[b0] if s0 > 0 else -dy4[b0]
        for b, s in rest:
            c = c + dy4[b] if s > 0 else c - dy4[b]
        out.append(c)
    return torch.stack(out)


def qgemm_stacked_plain(x4: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel H: ``x4 [4, M, K]`` with ``w [4, K, N]`` ->
    ``[4, M, N]`` in x4's dtype. X_COMBO combos in the storage dtype, the
    W_COMBO weight combos in it, products accumulated in f32, OUT_COMBO in
    f32."""
    xc = _x_combos(x4).float()
    wc = combine_weights(w, x4.dtype, W_COMBO).float()
    prods = torch.bmm(xc, wc)  # [10, M, N] f32
    o = device_table(OUT_COMBO, torch.float32, x4.device)
    return torch.einsum("pmn,bp->bmn", prods, o).to(x4.dtype)


def qgemm_dw_plain(x4: torch.Tensor, dy4: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel I: ``dw[a] = sum_p W_COMBO[p,a] xc_p^T dyc_p``
    for ``x4 [4, M, K]``, ``dy4 [4, M, N]`` -> ``[4, K, N]`` f32; both combos
    in the storage dtype, the products and the scatter in f32."""
    xc = _x_combos(x4).float()
    dyc = _dy_combos(dy4).float()
    prods = torch.bmm(xc.transpose(1, 2), dyc)  # [10, K, N]
    wt = device_table(W_COMBO, torch.float32, x4.device)
    return torch.einsum("pkn,pa->akn", prods, wt)


def dw_einsum(x4: torch.Tensor, dy4: torch.Tensor) -> torch.Tensor:
    """The 16-product dW (``qgemm.py:_dw_einsum``), for a short contraction
    M: ``dw[c] = sum_{a,b: comp[a,b] = c} sign[a,b] x_a^T dy_b``, products in
    f32. ``[4, M, K]``, ``[4, M, N]`` -> ``[4, K, N]`` f32."""
    prods = torch.einsum("amk,bmn->abkn", x4.float(), dy4.float())
    e = device_table(HAMILTON_E, torch.float32, x4.device)
    return torch.einsum("abkn,cab->ckn", prods, e)


def _pad8(v: int) -> int:
    return -(-v // 8) * 8


def qgemm10_cuda(x4: torch.Tensor, wc: torch.Tensor, *, role: str = "fwd",
                 lib=None) -> torch.Tensor:
    """Launch kernel H on ``x4 [4, M, K]`` and W_COMBO-combined ``wc [10, K,
    N]``: one CUDA device, contiguous, both f32 or both bf16, K and N
    multiples of 8. ``role`` ("fwd" or "dx") names the counter the launch
    adds to; ``lib`` a kernel library other than the package's (a variant
    built by ``qasr_torch.tools.ablate_qgemm``). Raises on anything the
    kernel does not take, or when it fails to build or launch."""
    if x4.ndim != 3 or x4.shape[0] != 4 or wc.ndim != 3 or wc.shape[0] != 10:
        raise ValueError(
            f"expected x4 [4,M,K] and wc [10,K,N], got {tuple(x4.shape)} and {tuple(wc.shape)}"
        )
    _, m, k = x4.shape
    n = wc.shape[2]
    if x4.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel H takes float32 or bfloat16, got {x4.dtype}")
    if k % 8 or n % 8:
        raise ValueError(f"kernel H needs K and N multiples of 8, got K={k} N={n}")
    _check_cuda_tensor("x4", x4, x4.dtype, x4.shape)
    _check_cuda_tensor("wc", wc, x4.dtype, (10, k, n))
    if wc.device != x4.device:
        raise ValueError(f"wc is on {wc.device}, x4 on {x4.device}")
    lib = lib if lib is not None else _build.load_library()
    y4 = torch.empty((4, m, n), dtype=x4.dtype, device=x4.device)
    if y4.numel() == 0:
        return y4
    v_tab, o_tab = _TABLES["fast10"]
    with torch.cuda.device(x4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qasr_qgemm10(
            x4.data_ptr(), wc.data_ptr(), y4.data_ptr(), m, k, n, _DTYPE_CODE[x4.dtype],
            v_tab.ctypes.data_as(ctypes.c_void_p), o_tab.ctypes.data_as(ctypes.c_void_p),
            stream,
        )
    _build.check(lib, err, "qgemm10 launch")
    if role == "dx":
        qgemm10_dx.launches += 1
    else:
        qgemm10.launches += 1
    return y4


def dw_splits(m: int, k: int, n: int, dtype: torch.dtype, sms: int) -> int:
    """The runs S of M that kernel I sums apart on a card of ``sms`` SMs
    (``dgt.splits`` with kernel I's chunk, tile and blocks per SM); S = 1
    writes dW in one pass."""
    return splits(m, k, n, chunk=_DW_CHUNK[dtype], tile=_DW_TILE,
                  blocks_per_sm=_DW_BLOCKS_PER_SM, sms=sms)


def qgemm10_dw_cuda(x4: torch.Tensor, dy4: torch.Tensor) -> torch.Tensor:
    """Launch kernel I (both its passes; one count) on ``x4 [4, M, K]`` and
    ``dy4 [4, M, N]``: one CUDA device, contiguous, both f32 or both bf16, K
    and N multiples of 8. M is split into :func:`dw_splits` runs summed into
    f32 partials, then added in a fixed order. Returns ``dw [4, K, N]``
    f32. Raises on anything the kernel does not take, or when it fails to
    build or launch."""
    if x4.ndim != 3 or x4.shape[0] != 4 or dy4.ndim != 3 or dy4.shape[:2] != x4.shape[:2]:
        raise ValueError(
            f"expected x4 [4,M,K] and dy4 [4,M,N], got {tuple(x4.shape)} and {tuple(dy4.shape)}"
        )
    _, m, k = x4.shape
    n = dy4.shape[2]
    if x4.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel I takes float32 or bfloat16, got {x4.dtype}")
    if k % 8 or n % 8:
        raise ValueError(f"kernel I needs K and N multiples of 8, got K={k} N={n}")
    _check_cuda_tensor("x4", x4, x4.dtype, x4.shape)
    _check_cuda_tensor("dy4", dy4, x4.dtype, dy4.shape)
    if dy4.device != x4.device:
        raise ValueError(f"dy4 is on {dy4.device}, x4 on {x4.device}")
    lib = _build.load_library()
    dw = torch.empty((4, k, n), dtype=torch.float32, device=x4.device)
    if dw.numel() == 0:
        return dw
    if m == 0:
        return dw.zero_()
    s = dw_splits(m, k, n, x4.dtype,
                  torch.cuda.get_device_properties(x4.device).multi_processor_count)
    part = torch.empty((s, 4, k, n), dtype=torch.float32, device=x4.device) if s > 1 else None
    xc_tab, oc_tab = _TABLES["fast10"]
    with torch.cuda.device(x4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qasr_qgemm10_dw(
            x4.data_ptr(), dy4.data_ptr(), None if part is None else part.data_ptr(),
            dw.data_ptr(), m, k, n, s, _DTYPE_CODE[x4.dtype],
            xc_tab.ctypes.data_as(ctypes.c_void_p), oc_tab.ctypes.data_as(ctypes.c_void_p),
            _W_COMBO_F32.ctypes.data_as(ctypes.c_void_p), stream,
        )
    _build.check(lib, err, "qgemm10_dw launch")
    qgemm10_dw.launches += 1
    return dw


def _qgemm10_padded(x4: torch.Tensor, w: torch.Tensor, role: str) -> torch.Tensor:
    """Kernel H on ``x4 [4, M, K]`` (CUDA) and ``w [4, K, N]``; ragged K and N
    are zero-padded to multiples of 8 here, ragged M is masked in the
    kernel."""
    k, n = w.shape[1], w.shape[2]
    kp, np_ = _pad8(k), _pad8(n)
    wc = combine_weights(w, x4.dtype, W_COMBO)
    if (kp, np_) != (k, n):
        x4 = F.pad(x4, (0, kp - k))
        wc = F.pad(wc, (0, np_ - n, 0, kp - k))
    y4 = qgemm10_cuda(x4.contiguous(), wc.contiguous(), role=role)
    return y4[:, :, :n] if np_ != n else y4


def qgemm10(x4: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Forward role: ``x4 [4, M, K]`` with ``w [4, K, N]`` -> ``[4, M, N]``.
    A CPU tensor takes the plain version; a CUDA tensor launches kernel H
    (counted in ``qgemm10.launches``) or raises."""
    if not x4.is_cuda:
        return qgemm_stacked_plain(x4, w)
    return _qgemm10_padded(x4, w, "fwd")


def qgemm10_dx(dy4: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx role: ``dy4 [4, M, N]`` -> ``dx4 [4, M, K]`` for the forward
    weights ``w [4, K, N]``, kernel H on the conj-transposed weights
    (counted in ``qgemm10_dx.launches``); a CPU tensor takes the plain
    version."""
    wt = conj_transpose_dense(w)
    if not dy4.is_cuda:
        return qgemm_stacked_plain(dy4, wt)
    return _qgemm10_padded(dy4, wt, "dx")


def qgemm10_dw(x4: torch.Tensor, dy4: torch.Tensor) -> torch.Tensor:
    """dW ``[4, K, N]`` f32 of the 10-product GEMM, routed as
    ``qgemm.py:308-313``: at ``M >= 256`` the 10-product form (kernel I on a
    CUDA tensor, counted in ``qgemm10_dw.launches``; its plain version on
    the CPU), below it the 16-product :func:`dw_einsum`."""
    m, k, n = x4.shape[1], x4.shape[2], dy4.shape[2]
    if m < DW_KERNEL_MIN_M:
        return dw_einsum(x4, dy4)
    if not x4.is_cuda:
        return qgemm_dw_plain(x4, dy4)
    kp, np_ = _pad8(k), _pad8(n)
    if (kp, np_) != (k, n):
        x4 = F.pad(x4, (0, kp - k))
        dy4 = F.pad(dy4, (0, np_ - n))
    dw = qgemm10_dw_cuda(x4.contiguous(), dy4.contiguous())
    return dw[:, :k, :n] if (kp, np_) != (k, n) else dw


#: launches of kernel H in its forward role, in its dx role, and of kernel I
#: since the last reset (counted where each launches)
qgemm10.launches = 0
qgemm10_dx.launches = 0
qgemm10_dw.launches = 0


class QGemmFn(torch.autograd.Function):
    """``y4 = qgemm(x4, w)``, 10 products: :func:`qgemm10` forward,
    :func:`qgemm10_dx` for dx, :func:`qgemm10_dw` for dW (in ``w``'s
    dtype)."""

    @staticmethod
    def forward(ctx, x4, w):
        ctx.save_for_backward(x4, w)
        return qgemm10(x4, w)

    @staticmethod
    def backward(ctx, dy4):
        x4, w = ctx.saved_tensors
        dy4 = dy4.contiguous()
        dx4 = qgemm10_dx(dy4, w) if ctx.needs_input_grad[0] else None
        return dx4, qgemm10_dw(x4, dy4).to(w.dtype)


def qgemm_stacked(x4: torch.Tensor, w: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """The differentiable 10-product quaternion GEMM on the stacked layout:
    ``x4 [4, M, K]`` with ``w [4, K, N]`` -> ``[4, M, N]`` in x's dtype.

    ``plain=True`` runs the plain version under autograd (the card's
    reference path); otherwise :class:`QGemmFn` (kernels H and I on a CUDA
    tensor, their plain versions on the CPU).
    """
    if w.ndim != 3 or w.shape[0] != 4 or w.shape[1] != x4.shape[-1]:
        raise ValueError(f"weights {tuple(w.shape)} incompatible with x4 {tuple(x4.shape)}")
    if plain:
        return qgemm_stacked_plain(x4, w)
    return QGemmFn.apply(x4.contiguous(), w)


def qgemm(x: torch.Tensor, w: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Packed quaternion GEMM: ``[M, 4K] x [4, K, N] -> [M, 4N]``."""
    m, k4 = x.shape
    if k4 % 4 or w.shape[:2] != (4, k4 // 4):
        raise ValueError(f"weights {tuple(w.shape)} incompatible with x {tuple(x.shape)}")
    x4 = x.reshape(m, 4, k4 // 4).transpose(0, 1)
    y4 = qgemm_stacked(x4, w, plain=plain)
    return y4.transpose(0, 1).reshape(m, 4 * w.shape[2])


def qdense_pallas(x: torch.Tensor, w: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Quaternion dense on the 10-product GEMM, any leading dims:
    ``[..., 4K] x [4, K, N] -> [..., 4N]`` (``qgemm.py:qdense_pallas``)."""
    lead = x.shape[:-1]
    out = qgemm(x.reshape(-1, x.shape[-1]), w, plain=plain)
    return out.reshape(*lead, out.shape[-1])


def qconv2d_pallas(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    strides=None,
    padding: str = "SAME",
    plain: bool = False,
) -> torch.Tensor:
    """Quaternion 2-D conv as slice-im2col plus the 10-product GEMM
    (``qgemm.py:qconv2d_pallas``).

    ``x [B, H, W, 4*Cin]`` packed (H over time, W over frequency in the
    models), ``w [4, kh, kw, Cin, Cout]``. The patches are the kh*kw shifted
    slices in offset-major order, stacked into the GEMM's ``[4, M, kh*kw*Cin]``
    layout with one transpose; the weights reshape to ``[4, kh*kw*Cin,
    Cout]`` with no data movement. Returns ``[B, Ho, Wo, 4*Cout]`` in x's
    dtype.
    """
    st, sf = (1, 1) if strides is None else tuple(strides)
    b, _, _, cin4 = x.shape
    cin = cin4 // 4
    _, kh, kw, _, cout = w.shape
    if padding == "SAME":
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        xp = F.pad(x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    elif padding == "VALID":
        xp = x
    else:
        raise ValueError(f"unsupported padding {padding!r}")
    ho = (xp.shape[1] - kh) // st + 1
    wo = (xp.shape[2] - kw) // sf + 1
    # offset-major patches: [B, Ho, Wo, S = kh*kw, 4, cin]
    slices = [
        xp[:, dt : dt + (ho - 1) * st + 1 : st, df : df + (wo - 1) * sf + 1 : sf, :]
        for dt in range(kh)
        for df in range(kw)
    ]
    m = b * ho * wo
    patches = torch.stack(slices, dim=3).reshape(m, kh * kw, 4, cin)
    # one transpose into the GEMM's layout [4, M, S*cin]
    p4 = patches.permute(2, 0, 1, 3).reshape(4, m, kh * kw * cin)
    out = qgemm_stacked(p4, w.reshape(4, kh * kw * cin, cout).to(x.dtype), plain=plain)
    return out.transpose(0, 1).reshape(b, ho, wo, 4 * cout)
