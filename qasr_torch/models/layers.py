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

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from qasr_torch.ops.initializers import glorot_uniform, lecun_normal, quaternion_init
from qasr_torch.ops.kernels import qconv_ft
from qasr_torch.ops.kernels.qconv_chain import chain_layer
from qasr_torch.ops.kernels.qgemm import qconv2d_pallas, qdense_pallas
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

    ``layout="btfc"``: packed ``[B, T, F, 4*Cin]`` in and out, on the block
    path (one ``F.conv2d`` on the 4x-expanded kernel) — the thin layer — or,
    with ``use_pallas`` where ``Cin * kh * kw >= 32`` (``layers.py:132-140``),
    on slice-im2col and the 10-product GEMM (:func:`qconv2d_pallas`: kernels
    H and I on a CUDA tensor).
    ``layout="stacked_ft"``: ``[B, 4, F, T, Cin]`` in and out through
    :func:`chain_layer` in ``scheme`` (``"fast8"``: kernels A and C;
    ``"fast10"``: kernels F and G), optionally applying the previous layer's
    PReLU slopes in its prologue. Parameters are the same in every case, so
    one checkpoint serves under every routing.
    """

    def __init__(
        self,
        cin: int,
        features: int,
        kernel_size: Sequence[int] = (3, 3),
        *,
        layout: str = "btfc",
        scheme: str = "fast8",
        use_pallas: bool = False,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        if layout not in ("btfc", "stacked_ft"):
            raise ValueError(f"unknown layout {layout!r}")
        self.layout = layout
        self.scheme = scheme
        # the im2col GEMM pays off once its contraction reaches a few tiles
        self.im2col = (
            use_pallas and layout == "btfc" and len(kernel_size) == 2
            and cin * kernel_size[0] * kernel_size[1] >= 32
        )
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
            return chain_layer(
                x, self.kernel, self.bias, alpha_prev, scheme=self.scheme, plain=plain
            )
        if alpha_prev is not None:
            raise ValueError("the packed layout has no PReLU prologue")
        if self.im2col:
            y = qconv2d_pallas(x, self.kernel.to(self.dtype), plain=plain)
        else:
            y = qconv(x, self.kernel.to(self.dtype))
        return y + self.bias.to(self.dtype)


class QDense(nn.Module):
    """Quaternion dense layer on packed ``[..., 4*K]`` input, through the
    rank-8 GEMM (``scheme="fast8"``: kernel B, forward and dx, on a CUDA
    tensor) or the 10-product GEMM (``"fast10"``: :func:`qdense_pallas`,
    kernel H forward and dx, kernel I for dW)."""

    def __init__(
        self,
        cin: int,
        features: int,
        *,
        scheme: str = "fast8",
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        if scheme not in ("fast8", "fast10"):
            raise ValueError(f"unknown scheme {scheme!r} (choose fast8 | fast10)")
        self.scheme = scheme
        self.dtype = dtype
        self.kernel = nn.Parameter(
            quaternion_init((4, cin, features), generator=generator, device=device)
        )
        self.bias = nn.Parameter(torch.zeros(4 * features, device=device))

    def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        gemm = qdense_pallas if self.scheme == "fast10" else qdense_pallas8
        y = gemm(x.to(self.dtype), self.kernel.to(self.dtype), plain=plain)
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
    """Real dense layer with the JAX layout: ``kernel [In, V]`` (drawn by
    ``kernel_init``: glorot-uniform unless the caller names another
    initializer of ``qasr_torch.ops.initializers``), ``bias [V]`` (zeros)."""

    def __init__(
        self,
        cin: int,
        features: int,
        *,
        kernel_init: Callable[..., torch.Tensor] = glorot_uniform,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(kernel_init((cin, features), generator=generator, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return x @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class Conv(nn.Module):
    """Real 2-D convolution with flax's layout and defaults (``nn.Conv``):
    ``kernel [kh, kw, Cin, Cout]`` (lecun-normal), ``bias [Cout]`` (zeros),
    stride 1, SAME padding, on channels-last ``[B, T, F, Cin]`` -> ``[B, T,
    F, Cout]`` (kh over T, kw over F). One cuDNN conv on the card, which
    takes the channels-last input as it lies."""

    def __init__(
        self,
        cin: int,
        features: int,
        kernel_size: Sequence[int] = (3, 3),
        *,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            lecun_normal((*kernel_size, cin, features), generator=generator, device=device)
        )
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)  # [kh,kw,I,O] -> [O,I,kh,kw]
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, self.bias.to(self.dtype),
                     padding="same")
        return y.permute(0, 2, 3, 1)


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
