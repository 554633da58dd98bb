"""Operand precision of the reference's products.

The reference computes in float32 with TF32 off (``"f32"``). Its control
computes the same functions with every operand of every product rounded to
a lower precision first, and the products summed in float32, as tensor
cores do: ``"tf32"`` (a 10-bit mantissa), ``"bf16"``, or ``"fp8"`` (e4m3
operands in the forward and e5m2 gradients in the backward, each scaled per
tensor to its largest magnitude, the usual fp8 training recipe).
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32", "bf16", "fp8")

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32's 10-bit mantissa, to nearest (ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    x = x.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).float() * scale


def round_to(x: torch.Tensor, prec: str, grad: bool = False) -> torch.Tensor:
    """``x`` rounded to ``prec`` and returned in f32 (no autograd)."""
    if prec == "f32":
        return x.float()
    if prec == "tf32":
        return _round_tf32(x)
    if prec == "bf16":
        return x.to(torch.bfloat16).float()
    if prec == "fp8":
        if grad:
            return _round_fp8(x, torch.float8_e5m2, _E5M2_MAX)
        return _round_fp8(x, torch.float8_e4m3fn, _E4M3_MAX)
    raise ValueError(f"unknown precision {prec!r} (choose {' | '.join(PRECISIONS)})")


class _Quant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, prec):
        ctx.prec = prec
        return round_to(x, prec)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.prec, grad=True), None


def q(x: torch.Tensor, prec: str) -> torch.Tensor:
    """An operand of a product at ``prec``: the identity in f32, else the
    rounded value, whose gradient is rounded the same way on its way back."""
    if prec == "f32":
        return x
    return _Quant.apply(x, prec)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and cuDNN convs within the block, restored after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
