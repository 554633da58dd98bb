"""The scan-resident rank-8 QLSTM recurrence: kernel D
(``qasr_torch/csrc/qlstm_scan8.cu``) and its plain PyTorch version, forward
only.

Counterpart of ``qasr/ops/pallas/qlstm_scan.py``: the TPU kernel
``_fwd_kernel`` runs the whole T-step bidirectional recurrence in one call
with the rank-8 recurrent weights resident in VMEM. On Hopper no SM holds
those weights (8.4 MB in bf16 at H=256), so kernel D is a persistent
cooperative kernel: each block keeps the weight columns of ``kJ = 4`` hidden
indices of one direction in shared memory for the whole scan, and one grid
barrier a step exchanges the hidden state through ``hs`` in device memory.
:func:`qlstm_scan_fwd_plain` is ``_fwd_xla`` step by step: the same math
(f32 within a step, h and c carried in the storage dtype) and the same
layouts and outputs ``(hs, cs, gates)``.

Layouts (as the JAX package's): ``xz [T, D, B, 16H]`` arrives packed
component-major ``[q, g, H]`` and is relaid gate-major ``[g, q, H]`` once;
``wc8 [D, 8, H, 4H]`` holds the U8-combined recurrent weights with columns
``[g, H]``; ``hs``, ``cs`` ``[T, D, B, 4H]`` are component-major; ``gates
[T, D, B, 16H]`` gate-major ``[sigma(i, f, o) | tanh(g)]``. Direction 1 runs
on the time-flipped stream and freezes its first ``T - len`` steps; the
kernel computes that mask from ``lengths [B]`` itself.

Kernel D has no backward yet: the TPU's ``_bwd_kernel`` is the next slice
(ROADMAP.md Queue 2). A CUDA call with grad enabled on an input that
requires grad raises instead of running the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qasr_torch.ops.kernels import _build
from qasr_torch.ops.kernels.qconv_ft import _DTYPE_CODE, _O8_F32, _V8_F32, _check_cuda_tensor
from qasr_torch.ops.quaternion import O8, V8

# 2-sparse V8 rows as ((component, coefficient), (component, coefficient)),
# the coefficients rounded to f32 as the kernel and the JAX twin use them
_V8_TERMS = tuple(
    tuple((a, float(np.float32(V8[p, a]))) for a in range(4) if V8[p, a] != 0.0)
    for p in range(8)
)

# hidden indices a kernel D block owns (kJ in csrc/qlstm_scan8.cu)
_J = 4
H100_SMS = 132  # SMs of an H100 SXM: the bound where no card is at hand


def device_sms(device: torch.device | str) -> int:
    """SMs of the CUDA card ``device``; :data:`H100_SMS` for any other device
    (or where CUDA is absent), so a CPU build routes as an H100 would."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def supported(hidden: int, dtype=torch.bfloat16, sms: int = H100_SMS) -> bool:
    """Whether kernel D runs a bidirectional recurrence of ``hidden``
    quaternion units on a card with ``sms`` SMs.

    The bound is Hopper's, not the TPU's 128-lane rule: bf16 or f32,
    ``hidden`` a multiple of 16 (the mma k-step), and the ``2 * hidden / 4``
    blocks of the cooperative grid co-resident at one block an SM (the
    kernel's launch bound). On an H100 SXM that admits hidden sizes 16..256;
    272 is the first refused (136 blocks). A block's shared memory admits
    more than the grid does at both dtypes; the launcher checks it exactly.
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
    o8 = torch.as_tensor(O8, dtype=torch.float32, device=xz_gm.device)
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
    with torch.cuda.device(xz_gm.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qasr_qlstm_scan8(
            xz_gm.data_ptr(), wc8.data_ptr(), None if lens is None else lens.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), gates.data_ptr(), t, d, b, hid,
            _DTYPE_CODE[xz_gm.dtype],
            _V8_F32.ctypes.data_as(ctypes.c_void_p),
            _O8_F32.ctypes.data_as(ctypes.c_void_p),
            stream,
        )
    _build.check(lib, err, "qlstm_scan8 launch")
    qlstm_scan_fast8.launches += 1
    return hs, cs, gates


def qlstm_scan_fwd(
    xz_gm: torch.Tensor,
    wc8: torch.Tensor,
    lengths: torch.Tensor | None = None,
    *,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(hs, cs, gates)`` of the recurrence on gate-major ``xz_gm``. A CPU
    tensor (or ``plain=True``) takes the plain version; a CUDA tensor
    launches kernel D or raises. Kernel D has no backward yet: with grad
    enabled on an input that requires grad, a CUDA call raises."""
    if plain or not xz_gm.is_cuda:
        return qlstm_scan_fwd_plain(xz_gm, wc8, lengths)
    if torch.is_grad_enabled() and (xz_gm.requires_grad or wc8.requires_grad):
        raise RuntimeError(
            "kernel D (qlstm_scan8) has no backward yet: it comes with config 4's "
            "training (ROADMAP.md Queue 2, qlstm_scan._bwd_kernel); run under "
            "torch.no_grad() or pass plain=True"
        )
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
