"""The scan-resident rank-8 QLSTM recurrence: kernel D
(``qasr_torch/csrc/qlstm_scan8.cu``, the forward), kernel E
(``qasr_torch/csrc/qlstm_scan8_bwd.cu``, the reverse-time backward), their
plain PyTorch versions, and the autograd Function that joins them.

Counterpart of ``qasr/ops/pallas/qlstm_scan.py``: the TPU kernels
``_fwd_kernel`` and ``_bwd_kernel`` each run the whole T-step bidirectional
recurrence in one call with the rank-8 recurrent weights resident in VMEM.
On Hopper no SM holds those weights (8.4 MB in bf16 at H=256), so both
kernels are persistent and cooperative: each block keeps the weights of a
few hidden indices of one direction in shared memory for the whole scan,
and one barrier a step among a direction's blocks exchanges what they need
(kernel D: the V8 combos of h in bf16, h in f32; kernel E: the blocks' f32
partials of the recurrent gradient). The plain
versions are ``_fwd_xla`` and ``_bwd_xla`` step by step: the same math
(f32 within a step; h and c carried in the storage dtype forward, dh and dc
in f32 backward) and the same layouts and outputs.

Layouts (as the JAX package's): ``xz [T, D, B, 16H]`` arrives packed
component-major ``[q, g, H]`` and is relaid gate-major ``[g, q, H]`` once;
``wc8 [D, 8, H, 4H]`` holds the U8-combined recurrent weights with columns
``[g, H]``; ``hs``, ``cs`` ``[T, D, B, 4H]`` are component-major; ``gates``
and ``dz`` ``[T, D, B, 16H]`` gate-major (``gates = [sigma(i, f, o) |
tanh(g)]``). Direction 1 runs on the time-flipped stream and freezes its
first ``T - len`` steps; the kernels compute that mask from ``lengths [B]``
themselves.

With grad enabled on an input that requires grad, :func:`qlstm_scan_fwd`
goes through :class:`QLstmScanFn` on both paths (the counterpart of the
``_scan_core`` custom VJP): kernels D and E on a CUDA tensor, the plain
versions on the CPU or with ``plain=True``, then :func:`qlstm_scan_dw`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qasr_torch.ops.kernels import _build
from qasr_torch.ops.kernels.qconv_ft import _DTYPE_CODE, _O8_F32, _V8_F32, _check_cuda_tensor
from qasr_torch.ops.quaternion import O8, V8, device_table
from qasr_torch.utils.profiling import span, traced

# 2-sparse V8 rows as ((component, coefficient), (component, coefficient)),
# the coefficients rounded to f32 as the kernel and the JAX twin use them
_V8_TERMS = tuple(
    tuple((a, float(np.float32(V8[p, a]))) for a in range(4) if V8[p, a] != 0.0)
    for p in range(8)
)
# V8 columns as ((product, coefficient), ...) for the backward's dh_a =
# sum_p V8[p, a] dhc_p, in the order _bwd_xla sums them (qlstm_scan.py:61)
_V8_COLS = tuple(
    tuple((p, float(np.float32(V8[p, a]))) for p in range(8) if V8[p, a] != 0.0)
    for a in range(4)
)

# hidden indices a kernel D block owns (kJ in csrc/qlstm_scan8.cu)
_J = 4
# hidden indices a kernel E block owns, by dtype (BwdOps<T>::kJ in
# csrc/qlstm_scan8_bwd.cu)
_BWD_J = {torch.bfloat16: 8, torch.float32: 4}
H100_SMS = 132  # SMs of an H100 SXM: the bound where no card is at hand


def device_sms(device: torch.device | str) -> int:
    """SMs of the CUDA card ``device``; :data:`H100_SMS` for any other device
    (or where CUDA is absent), so a CPU build routes as an H100 would."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def supported(hidden: int, dtype=torch.bfloat16, sms: int = H100_SMS) -> bool:
    """Whether kernels D and E run a bidirectional recurrence of ``hidden``
    quaternion units on a card with ``sms`` SMs.

    The bound is Hopper's, not the TPU's 128-lane rule: bf16 or f32,
    ``hidden`` a multiple of 16 (the mma k-step), and the ``2 * hidden / 4``
    blocks of kernel D's cooperative grid co-resident at one block an SM
    (the kernel's launch bound). On an H100 SXM that admits hidden sizes
    16..256; 272 is the first refused (136 blocks). Kernel E's grid is half
    of D's in bf16 (8 hidden indices a block) and the same in f32, so D's
    bound holds for both. A block's shared memory admits more than the grid
    does at both dtypes and in both kernels (D's: H <= 288, E's: H <= 416,
    past any Hopper card's 132 SMs); the launchers check it exactly.
    """
    return dtype in _DTYPE_CODE and hidden >= 16 and hidden % 16 == 0 and 2 * hidden // _J <= sms


def to_gate_major(xz: torch.Tensor) -> torch.Tensor:
    """``[T, D, B, 16H]`` component-major ``[q, g, H]`` -> gate-major
    ``[g, q, H]`` (``qlstm_scan.py:773-778``)."""
    t, d, b, c16 = xz.shape
    hid = c16 // 16
    return xz.reshape(t, d, b, 4, 4, hid).transpose(3, 4).reshape(t, d, b, c16)


def activity_mask(t: int, d: int, lengths: torch.Tensor | None, b: int, device) -> torch.Tensor:
    """``[T, D, B]`` f32: 1 where the recurrence steps, 0 where it freezes.
    Direction 0 steps while ``t < len``; direction 1 walks the flipped
    stream, so it freezes its first ``T - len`` steps (``qlstm_scan.py:780-788``)."""
    if lengths is None:
        return torch.ones((t, d, b), device=device)
    ti = torch.arange(t, device=device)[:, None]
    lens = lengths.to(device)[None, :]
    return torch.stack([ti < lens, (t - 1 - ti) < lens][:d], dim=1).float()


def qlstm_scan_fwd_plain(
    xz_gm: torch.Tensor, wc8: torch.Tensor, lengths: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel D: ``_fwd_xla`` (``qlstm_scan.py:434-495``) one
    step at a time. ``xz_gm [T, D, B, 16H]`` gate-major in the storage dtype,
    ``wc8 [D, 8, H, 4H]``; returns ``hs, cs [T, D, B, 4H]`` and ``gates [T, D,
    B, 16H]`` in the storage dtype. The combos are formed in f32 and rounded to
    the storage dtype, the products of storage-dtype values summed in f32;
    h and c are rounded to the storage dtype every step."""
    t, d, b, c16 = xz_gm.shape
    hid = c16 // 16
    h4 = 4 * hid
    dt = xz_gm.dtype
    if t == 0:
        empty = xz_gm.new_zeros((0, d, b, h4))
        return empty, empty.clone(), xz_gm.new_zeros((0, d, b, c16))
    wc = wc8.to(dt).float()
    o8 = device_table(O8, torch.float32, xz_gm.device)
    mask = activity_mask(t, d, lengths, b, xz_gm.device)[..., None]  # [T, D, B, 1]
    h = xz_gm.new_zeros((d, b, h4))
    c = xz_gm.new_zeros((d, b, h4))
    hs, cs, gs = [], [], []
    for s in range(t):
        hf = h.float()
        ha = hf.reshape(d, b, 4, hid)
        hc = torch.stack(
            [ha[:, :, a1] * c1 + ha[:, :, a2] * c2 for (a1, c1), (a2, c2) in _V8_TERMS], dim=1
        )  # [D, 8, B, H]
        prods = torch.matmul(hc.to(dt).float(), wc)  # [D, 8, B, 4H], lanes [g, H]
        proj = torch.einsum("dpbgh,qp->dbgqh", prods.reshape(d, 8, b, 4, hid), o8)
        z = xz_gm[s].float() + proj.reshape(d, b, c16)
        sig = torch.sigmoid(z[..., : 3 * h4])
        g_t = torch.tanh(z[..., 3 * h4 :])
        i_t, f_t, o_t = sig.split(h4, dim=-1)
        cf = c.float()
        c_cand = f_t * cf + i_t * g_t
        h_cand = o_t * torch.tanh(c_cand)
        m = mask[s]
        h = (m * h_cand + (1.0 - m) * hf).to(dt)
        c = (m * c_cand + (1.0 - m) * cf).to(dt)
        hs.append(h)
        cs.append(c)
        gs.append(torch.cat([sig, g_t], dim=-1).to(dt))
    return torch.stack(hs), torch.stack(cs), torch.stack(gs)


def qlstm_scan_cuda(
    xz_gm: torch.Tensor,
    wc8: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    lib=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel D: ``xz_gm [T, 2, B, 16H]`` gate-major (both directions)
    and ``wc8 [2, 8, H, 4H]`` on one CUDA device, contiguous, both f32 or
    both bf16; ``lengths [B]`` (any integer type) or None. ``lib`` is the
    kernel library to launch from (default: :func:`_build.load_library`).
    Returns ``(hs, cs, gates)``. Raises on anything the kernel does not take
    (see :func:`supported`), when the cooperative grid cannot be co-resident,
    or when it fails to build or launch."""
    if xz_gm.ndim != 4 or xz_gm.shape[-1] % 16:
        raise ValueError(f"expected xz [T, D, B, 16H], got {tuple(xz_gm.shape)}")
    t, d, b, c16 = xz_gm.shape
    hid = c16 // 16
    if xz_gm.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel D takes float32 or bfloat16, got {xz_gm.dtype}")
    if d != 2:
        raise ValueError(f"kernel D runs both directions in one launch, got D={d}")
    sms = device_sms(xz_gm.device)
    if not supported(hid, xz_gm.dtype, sms):
        raise ValueError(
            f"kernel D does not support hidden={hid} in {xz_gm.dtype}: its grid of "
            f"{2 * hid // _J} blocks, one an SM, exceeds the card's {sms} SMs"
        )
    _check_cuda_tensor("xz", xz_gm, xz_gm.dtype, xz_gm.shape)
    _check_cuda_tensor("wc8", wc8, xz_gm.dtype, (d, 8, hid, 4 * hid))
    if wc8.device != xz_gm.device:
        raise ValueError(f"wc8 is on {wc8.device}, xz on {xz_gm.device}")
    lens = None
    if lengths is not None:
        if tuple(lengths.shape) != (b,):
            raise ValueError(f"lengths must have shape {(b,)}, got {tuple(lengths.shape)}")
        lens = lengths.to(device=xz_gm.device, dtype=torch.int32).contiguous()
    lib = _build.load_library() if lib is None else lib
    hs = torch.empty((t, d, b, 4 * hid), dtype=xz_gm.dtype, device=xz_gm.device)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(xz_gm)
    if hs.numel() == 0:
        return hs, cs, gates
    # scratch: bf16 exchanges the V8 combos of h (ping-pong by the parity of
    # t, rows padded by 8), f32 exchanges hs itself; the direction barriers'
    # counters, zeroed
    xc = (torch.empty((2, d, 8, b, hid + 8), dtype=xz_gm.dtype, device=xz_gm.device)
          if xz_gm.dtype == torch.bfloat16 else None)
    bar = torch.zeros(d, dtype=torch.int32, device=xz_gm.device)
    with torch.cuda.device(xz_gm.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qasr_qlstm_scan8(
            xz_gm.data_ptr(), wc8.data_ptr(), None if lens is None else lens.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), gates.data_ptr(),
            None if xc is None else xc.data_ptr(), bar.data_ptr(), t, d, b, hid,
            _DTYPE_CODE[xz_gm.dtype],
            _V8_F32.ctypes.data_as(ctypes.c_void_p),
            _O8_F32.ctypes.data_as(ctypes.c_void_p),
            stream,
        )
    _build.check(lib, err, "qlstm_scan8 launch")
    qlstm_scan_fast8.launches += 1
    return hs, cs, gates


def qlstm_scan_bwd_plain(
    wc8: torch.Tensor,
    gates: torch.Tensor,
    cs: torch.Tensor,
    dhs: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of kernel E: ``_bwd_xla`` (``qlstm_scan.py:498-578``) one
    step at a time, t from T-1 down to 0. ``wc8 [D, 8, H, 4H]``, the forward's
    ``gates [T, D, B, 16H]`` and ``cs [T, D, B, 4H]``, and the upstream
    ``dhs [T, D, B, 4H]``, all in the storage dtype; returns ``dz [T, D, B,
    16H]`` gate-major in the storage dtype. dh and dc are carried in f32;
    ``c_prev`` is ``cs[t-1]`` (zero at t = 0). The recurrent part forms
    ``dprods_p = sum_q O8[q, p] dz_q`` from the f32 ``dz`` and rounds it once
    to the storage dtype; its products with the weights sum in f32."""
    t, d, b, c16 = gates.shape
    hid = c16 // 16
    h4 = 4 * hid
    dt = gates.dtype
    if t == 0:
        return torch.zeros_like(gates)
    wt = wc8.to(dt).float().transpose(-1, -2)  # [D, 8, 4H, H]
    o8 = device_table(O8, torch.float32, gates.device).view(4, 1, 8, 1, 1, 1)
    mask = activity_mask(t, d, lengths, b, gates.device)[..., None]  # [T, D, B, 1]
    dh = torch.zeros((d, b, h4), device=gates.device)
    dc = torch.zeros_like(dh)
    dzs = [None] * t
    for s in range(t - 1, -1, -1):
        i_t, f_t, o_t, g_t = gates[s].float().split(h4, dim=-1)
        cpf = cs[s - 1].float() if s > 0 else torch.zeros_like(dh)
        c_cand = f_t * cpf + i_t * g_t
        th = torch.tanh(c_cand)
        m = mask[s]
        dh_tot = dhs[s].float() + dh
        dh_cand = m * dh_tot
        dc_cand = m * dc + dh_cand * o_t * (1.0 - th * th)
        do = dh_cand * th
        df = dc_cand * cpf
        di = dc_cand * g_t
        dg = dc_cand * i_t
        dc = (1.0 - m) * dc + dc_cand * f_t
        dz = torch.cat([di * i_t * (1.0 - i_t), df * f_t * (1.0 - f_t),
                        do * o_t * (1.0 - o_t), dg * (1.0 - g_t * g_t)], dim=-1)
        dzs[s] = dz.to(dt)
        # dprods_p = sum_q O8[q, p] dz[g, q], summed over q in order
        dzq = dz.reshape(d, 1, b, 4, 4, hid).movedim(4, 0)  # [q][D, 1, B, g, H]
        dprods = dzq[0] * o8[0]
        for q in range(1, 4):
            dprods = dprods + dzq[q] * o8[q]  # [D, 8, B, g, H]
        dprods = dprods.reshape(d, 8, b, h4).to(dt).float()
        dhc = torch.matmul(dprods, wt)  # [D, 8, B, H]
        dh_rec = []
        for terms in _V8_COLS:
            (p0, c0), *rest = terms
            acc = dhc[:, p0] * c0
            for p, coef in rest:
                acc = acc + dhc[:, p] * coef
            dh_rec.append(acc)
        dh = (1.0 - m) * dh_tot + torch.cat(dh_rec, dim=-1)
    return torch.stack(dzs)


def qlstm_scan_bwd_cuda(
    wc8: torch.Tensor,
    gates: torch.Tensor,
    cs: torch.Tensor,
    dhs: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    lib=None,
) -> torch.Tensor:
    """Launch kernel E: ``gates [T, 2, B, 16H]``, ``cs`` and ``dhs [T, 2, B,
    4H]``, ``wc8 [2, 8, H, 4H]`` on one CUDA device, contiguous, all f32 or
    all bf16; ``lengths [B]`` or None. Returns ``dz`` like ``gates``. The
    wrapper allocates the scratch: the blocks' f32 partials of the
    recurrent gradient ``[2, D, H / kJ, B, 4H]`` (ping-pong by the parity of
    t; kJ = 8 in bf16, 4 in f32), the f32 carry ``[2, D, B, 4H]`` of rows
    past the first 32, and the two direction barriers' counters, zeroed.
    Raises on anything the kernel does not take, when the cooperative grid
    cannot be co-resident, or when it fails to build or launch."""
    if gates.ndim != 4 or gates.shape[-1] % 16:
        raise ValueError(f"expected gates [T, D, B, 16H], got {tuple(gates.shape)}")
    t, d, b, c16 = gates.shape
    hid = c16 // 16
    dt = gates.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"kernel E takes float32 or bfloat16, got {dt}")
    if d != 2:
        raise ValueError(f"kernel E runs both directions in one launch, got D={d}")
    sms = device_sms(gates.device)
    if not supported(hid, dt, sms):
        raise ValueError(f"kernel E does not support hidden={hid} in {dt} on {sms} SMs")
    _check_cuda_tensor("gates", gates, dt, gates.shape)
    for name, v in (("cs", cs), ("dhs", dhs)):
        _check_cuda_tensor(name, v, dt, (t, d, b, 4 * hid))
    _check_cuda_tensor("wc8", wc8, dt, (d, 8, hid, 4 * hid))
    for name, v in (("cs", cs), ("dhs", dhs), ("wc8", wc8)):
        if v.device != gates.device:
            raise ValueError(f"{name} is on {v.device}, gates on {gates.device}")
    lens = None
    if lengths is not None:
        if tuple(lengths.shape) != (b,):
            raise ValueError(f"lengths must have shape {(b,)}, got {tuple(lengths.shape)}")
        lens = lengths.to(device=gates.device, dtype=torch.int32).contiguous()
    lib = _build.load_library() if lib is None else lib
    dz = torch.empty_like(gates)
    if dz.numel() == 0:
        return dz
    part = torch.empty((2, d, hid // _BWD_J[dt], b, 4 * hid), dtype=torch.float32,
                       device=gates.device)
    carry = torch.empty((2, d, b, 4 * hid), dtype=torch.float32, device=gates.device)
    bar = torch.zeros(d, dtype=torch.int32, device=gates.device)
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qasr_qlstm_scan8_bwd(
            gates.data_ptr(), cs.data_ptr(), dhs.data_ptr(), wc8.data_ptr(),
            None if lens is None else lens.data_ptr(), dz.data_ptr(), part.data_ptr(),
            carry[0].data_ptr(), carry[1].data_ptr(), bar.data_ptr(), t, d, b, hid,
            _DTYPE_CODE[dt],
            _V8_F32.ctypes.data_as(ctypes.c_void_p),
            _O8_F32.ctypes.data_as(ctypes.c_void_p),
            stream,
        )
    _build.check(lib, err, "qlstm_scan8_bwd launch")
    qlstm_scan_bwd.launches += 1
    return dz


def qlstm_scan_bwd(
    wc8: torch.Tensor,
    gates: torch.Tensor,
    cs: torch.Tensor,
    dhs: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """``dz`` of the recurrence (see :func:`qlstm_scan_bwd_plain`). A CPU
    tensor (or ``plain=True``) takes the plain version; a CUDA tensor
    launches kernel E or raises."""
    if plain or not gates.is_cuda:
        return qlstm_scan_bwd_plain(wc8, gates, cs, dhs, lengths)
    return qlstm_scan_bwd_cuda(wc8.contiguous(), gates.contiguous(), cs.contiguous(),
                               dhs.contiguous(), lengths)


def qlstm_scan_dw(hs: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """``dwc8 [D, 8, H, 4H]`` from the forward's ``hs [T, D, B, 4H]`` and
    ``dz [T, D, B, 16H]`` (gate-major): the two dW einsums of
    ``_scan_core_bwd`` (``qlstm_scan.py:711-727``), batched GEMMs over the
    ``T * B`` rows. ``h_prev`` is ``hs`` one step back in scan order (zero
    at t = 0; direction 1 on its flipped stream). The V8 combos of ``h_prev``
    and the O8 combos of ``dz`` are formed in the storage dtype, as the JAX
    einsums form them; their products accumulate in f32 (the matmul's
    accumulator) and come back in the storage dtype."""
    t, d, b, h4 = hs.shape
    hid = h4 // 4
    h_prev = torch.cat([hs.new_zeros((1, d, b, h4)), hs[:-1]])
    v8 = device_table(V8, hs.dtype, hs.device)
    o8 = device_table(O8, dz.dtype, dz.device)
    hcp = torch.einsum("tdbak,pa->dptbk", h_prev.reshape(t, d, b, 4, hid), v8)
    dpr = torch.einsum("tdbgqh,qp->dptbgh", dz.reshape(t, d, b, 4, 4, hid), o8)
    hcp = hcp.reshape(d, 8, t * b, hid)
    return torch.matmul(hcp.transpose(-1, -2), dpr.reshape(d, 8, t * b, h4))


class QLstmScanFn(torch.autograd.Function):
    """``(hs, cs, gates)`` of the recurrence with its backward: the
    counterpart of the ``_scan_core`` custom VJP (``qlstm_scan.py:693-731``).
    Forward: kernel D, or the plain version on the CPU or with ``plain``;
    it saves ``wc8, lengths, hs, cs, gates``. Backward: kernel E or the
    plain version for ``dz``, then :func:`qlstm_scan_dw`; it returns ``dxz =
    dz``, ``dwc8`` in wc8's dtype, and no gradient for the lengths. ``cs``
    and ``gates`` are residuals, not differentiable outputs."""

    @staticmethod
    def forward(ctx, xz_gm, wc8, lengths, plain):
        if plain or not xz_gm.is_cuda:
            hs, cs, gates = qlstm_scan_fwd_plain(xz_gm, wc8, lengths)
        else:
            hs, cs, gates = qlstm_scan_cuda(xz_gm.contiguous(), wc8.contiguous(), lengths)
        ctx.plain = plain
        ctx.save_for_backward(wc8, lengths, hs, cs, gates)
        ctx.mark_non_differentiable(cs, gates)
        return hs, cs, gates

    @staticmethod
    def backward(ctx, dhs, _dcs, _dgates):
        wc8, lengths, hs, cs, gates = ctx.saved_tensors
        dhs = torch.zeros_like(hs) if dhs is None else dhs.to(gates.dtype)
        dz = qlstm_scan_bwd(wc8, gates, cs, dhs, lengths, plain=ctx.plain)
        dwc8 = qlstm_scan_dw(hs, dz).to(wc8.dtype) if ctx.needs_input_grad[1] else None
        return dz, dwc8, None, None


def qlstm_scan_fwd(
    xz_gm: torch.Tensor,
    wc8: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(hs, cs, gates)`` of the recurrence on gate-major ``xz_gm``. A CPU
    tensor (or ``plain=True``) takes the plain version; a CUDA tensor
    launches kernel D or raises. With grad enabled on an input that requires
    grad, both paths go through :class:`QLstmScanFn`, whose backward is
    kernel E on the kernel path and the plain backward on the plain path."""
    if torch.is_grad_enabled() and (xz_gm.requires_grad or wc8.requires_grad):
        return traced("qasr.qlstm_scan", QLstmScanFn.apply, xz_gm, wc8, lengths, plain)
    with span("qasr.qlstm_scan"):
        if plain or not xz_gm.is_cuda:
            return qlstm_scan_fwd_plain(xz_gm, wc8, lengths)
        return qlstm_scan_cuda(xz_gm.contiguous(), wc8.contiguous(), lengths)


def qlstm_scan_fast8(
    xz: torch.Tensor,
    wc8: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """Scan-resident rank-8 QLSTM recurrence (contract of
    ``qasr/ops/pallas/qlstm_scan.py:qlstm_scan_fast8``).

    Args:
      xz: ``[T, D, B, 16H]`` input projections (+bias), packed
        component-major ``[q, g, H]``, direction 1 (if D=2) time-flipped.
      wc8: ``[D, 8, H, 4H]`` U8-combined recurrent weights.
      lengths: optional ``[B]`` frame counts; the state freezes past each
        utterance's last frame (direction 1 freezes its first ``T - len``
        steps).
      plain: run the plain version on any device.

    Returns ``hs [T, D, B, 4H]`` (component-major, direction 1 still
    flipped). A CPU tensor takes the plain version; a CUDA tensor launches
    kernel D or raises.
    """
    t, d, b, c16 = xz.shape
    hid = c16 // 16
    if c16 % 16 or tuple(wc8.shape) != (d, 8, hid, 4 * hid):
        raise ValueError(f"wc8 shape {tuple(wc8.shape)} != {(d, 8, hid, 4 * hid)}")
    hs, _, _ = qlstm_scan_fwd(to_gate_major(xz), wc8, lengths, plain=plain)
    return hs


#: launches of kernel D since the last reset (counted where it launches)
qlstm_scan_fast8.launches = 0
#: launches of kernel E since the last reset (counted where it launches)
qlstm_scan_bwd.launches = 0
