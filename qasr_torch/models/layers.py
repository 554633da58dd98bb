"""Quaternion layers as ``nn.Module``s (counterpart of ``qasr/models/layers.py``).

Parameters keep the JAX package's names and shapes exactly
(``docs/checkpoint_layout.md``): ``kernel [4, kh, kw, Cin, Cout]`` and
``bias [4*Cout]`` for a conv, ``kernel [4, K, N]`` and ``bias [4*N]`` for a
dense layer, ``alpha [4*C]`` for the split PReLU. Parameters are f32 master
weights; each layer casts them to its compute ``dtype`` (e.g. bf16) at use,
as the JAX layers do, so gradients come back to the f32 parameters.
Parameters are made on ``device``: the GPU unless the caller asks for the
CPU.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from qasr_torch.ops.initializers import quaternion_init
from qasr_torch.ops.kernels import qconv_ft
from qasr_torch.ops.kernels.qconv_chain import chain_layer
from qasr_torch.ops.kernels.qgemm8 import qdense_pallas8
from qasr_torch.ops.qlinalg import qconv


def flatten_quaternion(x: torch.Tensor) -> torch.Tensor:
    """Fold the frequency dim into the quaternion channels, keeping
    component-major packing: ``[..., F, 4*C] -> [..., 4*(F*C)]``."""
    *lead, f, c4 = x.shape
    x = x.reshape(*lead, f, 4, c4 // 4).movedim(-2, -3)  # [..., 4, F, C]
    return x.reshape(*lead, f * c4)


def tf_packed_to_stacked(x: torch.Tensor) -> torch.Tensor:
    """[B, T, F, 4C] packed -> [B, 4, F, T, C] component-stacked F-major
    (a view)."""
    return qconv_ft.pack_to_stacked(x.transpose(1, 2))


def stacked_to_tf_packed(x: torch.Tensor) -> torch.Tensor:
    """[B, 4, F, T, C] stacked -> [B, T, F, 4C] packed."""
    return qconv_ft.stacked_to_pack(x).transpose(1, 2)


class QConv(nn.Module):
    """Quaternion 2-D convolution.

    ``layout="btfc"``: packed ``[B, T, F, 4*Cin]`` in and out, block path
    (one ``F.conv2d`` on the 4x-expanded kernel) — the thin layer.
    ``layout="stacked_ft"``: ``[B, 4, F, T, Cin]`` in and out through
    :func:`chain_layer` (kernels A and C on a CUDA tensor), optionally
    applying the previous layer's PReLU slopes in its prologue.
    """

    def __init__(
        self,
        cin: int,
        features: int,
        kernel_size: Sequence[int] = (3, 3),
        *,
        layout: str = "btfc",
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        if layout not in ("btfc", "stacked_ft"):
            raise ValueError(f"unknown layout {layout!r}")
        self.layout = layout
        self.dtype = dtype
        self.kernel = nn.Parameter(
            quaternion_init((4, *kernel_size, cin, features), generator=generator, device=device)
        )
        self.bias = nn.Parameter(torch.zeros(4 * features, device=device))

    def forward(
        self,
        x: torch.Tensor,
        *,
        alpha_prev: torch.Tensor | None = None,
        plain: bool = False,
    ) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.layout == "stacked_ft":
            return chain_layer(x, self.kernel, self.bias, alpha_prev, plain=plain)
        if alpha_prev is not None:
            raise ValueError("the packed layout has no PReLU prologue")
        y = qconv(x, self.kernel.to(self.dtype))
        return y + self.bias.to(self.dtype)


class QDense(nn.Module):
    """Quaternion dense layer on packed ``[..., 4*K]`` input, through the
    rank-8 GEMM (kernel B, forward and dx, on a CUDA tensor)."""

    def __init__(
        self,
        cin: int,
        features: int,
        *,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            quaternion_init((4, cin, features), generator=generator, device=device)
        )
        self.bias = nn.Parameter(torch.zeros(4 * features, device=device))

    def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        y = qdense_pallas8(x.to(self.dtype), self.kernel.to(self.dtype), plain=plain)
        return y + self.bias.to(self.dtype)


class PReLU(nn.Module):
    """Split (component-wise) PReLU: ``x >= 0 ? x : alpha * x`` with one slope
    per real channel, ``alpha [4*C]``. Takes packed ``[..., 4C]`` or stacked
    ``[B, 4, F, T, C]`` input."""

    def __init__(self, channels: int, negative_slope_init: float = 0.25, *, device="cuda"):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), negative_slope_init, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.to(x.dtype)
        if x.ndim == 5 and x.shape[1] == 4:
            a = a.reshape(4, 1, 1, x.shape[-1])
        return torch.where(x >= 0, x, a * x)


class Dense(nn.Module):
    """Real dense layer with the JAX layout: ``kernel [In, V]``, ``bias [V]``
    (glorot-uniform kernel, zero bias)."""

    def __init__(
        self,
        cin: int,
        features: int,
        *,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        self.dtype = dtype
        limit = (6.0 / (cin + features)) ** 0.5
        gdev = generator.device if generator is not None else torch.device("cpu")
        k = (torch.rand(cin, features, generator=generator, device=gdev) * 2 - 1) * limit
        self.kernel = nn.Parameter(k.to(device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return x @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class Dropout(nn.Module):
    """Inverted dropout (as flax's ``nn.Dropout``): in train mode each element
    is kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``;
    in eval mode, or at rate 0, the identity. The mask is drawn from the
    explicit ``generator`` the caller passes (on x's device); torch's global
    RNG is never used."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout needs an explicit torch.Generator")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))
