"""The QCNN acoustic model (counterpart of ``qasr/models/qcnn.py``).

Input: packed quaternion features ``[B, T, F_mel, 4]`` (one quaternion
channel: fbank, Δ, ΔΔ, ΔΔΔ). Output: framewise CTC logits ``[B, T, vocab]``
in f32. Time stride is 1 throughout. In train mode, dropout at
``dropout_rate`` follows each dense PReLU (``qasr/models/qcnn.py:279-280``);
there is no conv dropout, as in every preset.

Layer order, as in the JAX encoder: thin conv(s) in the packed layout, each
with its split PReLU; a frequency-only ``(1, pool)`` VALID max-pool after
``pool_after`` layers; then every post-pool layer that kernel A supports runs
in the component-stacked F-major layout ``[B, 4, F, T, C]``: one transpose in,
each layer ``bias + qconv8(prelu_prev(x))`` (the previous layer's PReLU
fused into the conv's prologue), the last PReLU in torch, and one transpose
out to ``[B, T, 4*F*C]``; then the quaternion dense layers with their PReLUs
and the real output layer.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from qasr_torch.models.layers import (
    Dense,
    Dropout,
    PReLU,
    QConv,
    QDense,
    flatten_quaternion,
    stacked_to_tf_packed,
    tf_packed_to_stacked,
)
from qasr_torch.ops.kernels import qconv_ft


def stacked_routing(
    conv_features: Sequence[int],
    kernel_size: tuple[int, int],
    pool_after: int,
    cin: int = 1,
) -> list[bool]:
    """Which conv layers run in the stacked layout: post-pool layers that
    kernel A's ``supported()`` admits. (The TPU's ``>= 128`` channel gate for
    its matrix-unit lanes is not carried over.)"""
    out = []
    for i, feats in enumerate(conv_features):
        out.append(
            i >= pool_after
            and len(kernel_size) == 2
            and qconv_ft.supported(cin, feats, kernel_size, "SAME", None)
        )
        cin = feats
    return out


def quaternion_conv_tower(
    x: torch.Tensor,
    convs: Sequence[QConv],
    acts: Sequence[PReLU],
    stacked: Sequence[bool],
    *,
    pool_after: int,
    pool_size: int,
    plain: bool = False,
) -> tuple[torch.Tensor, bool]:
    """Run the conv tower (counterpart of ``qasr.models.qcnn.quaternion_conv_tower``
    without conv dropout) on packed ``x [B, T, F, 4*C]``.

    ``stacked[i]`` says whether layer i runs in the stacked layout (see
    :func:`stacked_routing`; the layers were built to match). A run of
    stacked layers passes pre-activations: each layer's PReLU is applied in
    the next layer's prologue, and the run's last PReLU in torch. Returns
    ``(x, in_stacked)``: when ``in_stacked`` the result is still
    ``[B, 4, F, T, C]`` and the caller owns the exit transpose.
    """
    in_stacked = False
    pending = None  # PReLU deferred into the next stacked conv's prologue
    for i, (conv, act) in enumerate(zip(convs, acts)):
        if in_stacked and not stacked[i]:
            x = stacked_to_tf_packed(pending(x))
            in_stacked, pending = False, None
        if stacked[i]:
            if not in_stacked:
                x = tf_packed_to_stacked(x).contiguous()
                in_stacked = True
            alpha = None if pending is None else pending.alpha
            x = conv(x, alpha_prev=alpha, plain=plain)
            pending = act
        else:
            x = act(conv(x, plain=plain))
        if i + 1 == pool_after:
            # frequency only: time resolution feeds CTC
            x = F.max_pool2d(
                x.permute(0, 3, 1, 2), kernel_size=(1, pool_size), stride=(1, pool_size)
            ).permute(0, 2, 3, 1)
    if in_stacked:
        x = pending(x)
    return x, in_stacked


class ConvTowerEncoder(nn.Module):
    """Base of the encoders that open with the quaternion conv tower: its
    layers ``qconv_<i>`` / ``conv_prelu_<i>`` (the JAX names) and the run
    from packed features to ``[B, T, 4*(F*C)]``."""

    def _build_tower(
        self,
        n_feats: int,
        conv_features: Sequence[int],
        kernel_size: tuple[int, int],
        pool_after: int,
        pool_size: int,
        **common,
    ) -> int:
        """Add the conv layers; returns the quaternion width ``F * C`` that
        the tower hands on."""
        self.pool_after = pool_after
        self.pool_size = pool_size
        self.stacked = stacked_routing(conv_features, kernel_size, pool_after)
        device = common["device"]
        cin, f = 1, n_feats
        for i, feats in enumerate(conv_features):
            layout = "stacked_ft" if self.stacked[i] else "btfc"
            self.add_module(
                f"qconv_{i}", QConv(cin, feats, kernel_size, layout=layout, **common)
            )
            self.add_module(f"conv_prelu_{i}", PReLU(4 * feats, device=device))
            if i + 1 == pool_after:
                f = (f - pool_size) // pool_size + 1
            cin = feats
        return f * cin

    def _run_tower(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        """``x [B, T, F, 4]`` -> ``[B, T, 4*(F*C)]`` in the compute dtype."""
        if x.ndim != 4:
            raise ValueError(f"expected [B, T, F, 4*C] input, got {tuple(x.shape)}")
        n = len(self.stacked)
        x, in_stacked = quaternion_conv_tower(
            x.to(self.dtype),
            [getattr(self, f"qconv_{i}") for i in range(n)],
            [getattr(self, f"conv_prelu_{i}") for i in range(n)],
            self.stacked,
            pool_after=self.pool_after,
            pool_size=self.pool_size,
            plain=plain,
        )
        if in_stacked:
            # the single exit transpose: [B,4,F,T,C] -> [B,T,4*(F*C)]
            b, _, f, t, c = x.shape
            return x.permute(0, 3, 1, 2, 4).reshape(b, t, 4 * f * c)
        return flatten_quaternion(x)


class QCNNEncoder(ConvTowerEncoder):
    """Quaternion CNN encoder -> framewise CTC logits ``[B, T, vocab]``.

    Submodules are named as the JAX parameter tree (``qconv_<i>``,
    ``conv_prelu_<i>``, ``qdense_<i>``, ``dense_prelu_<i>``, ``output``), so
    ``state_dict()`` keys are the JAX names joined with dots.
    """

    def __init__(
        self,
        *,
        n_feats: int,
        conv_features: Sequence[int] = (32, 32, 64, 64, 64, 64, 64, 64, 64, 64),
        dense_features: Sequence[int] = (256, 256, 256),
        vocab: int = 62,
        kernel_size: tuple[int, int] = (3, 3),
        pool_after: int = 1,
        pool_size: int = 3,
        dropout_rate: float = 0.3,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        self.dtype = dtype
        common = dict(dtype=dtype, generator=generator, device=device)
        k = self._build_tower(n_feats, conv_features, kernel_size, pool_after, pool_size, **common)
        self.n_dense = len(dense_features)
        for i, feats in enumerate(dense_features):
            self.add_module(f"qdense_{i}", QDense(k, feats, **common))
            self.add_module(f"dense_prelu_{i}", PReLU(4 * feats, device=device))
            self.add_module(f"dense_dropout_{i}", Dropout(dropout_rate))
            k = feats
        self.output = Dense(4 * k, vocab, **common)

    def forward(
        self,
        x: torch.Tensor,
        *,
        lengths: torch.Tensor | None = None,
        plain: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``x [B, T, F, 4]`` -> logits ``[B, T, vocab]`` f32. ``plain=True``
        runs every kernel's plain PyTorch version, on any device. In train
        mode the dropout masks come from ``generator`` (on x's device).
        ``lengths`` is accepted and unused: the model is frame-local, as the
        JAX encoder's (``qasr/models/qcnn.py:222``)."""
        del lengths
        x = self._run_tower(x, plain)
        for i in range(self.n_dense):
            x = getattr(self, f"dense_prelu_{i}")(getattr(self, f"qdense_{i}")(x, plain=plain))
            x = getattr(self, f"dense_dropout_{i}")(x, generator)
        return self.output(x).float()
