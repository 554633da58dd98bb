"""The QCNN acoustic model (counterpart of ``qasr/models/qcnn.py``).

Input: packed quaternion features ``[B, T, F_mel, 4]`` (one quaternion
channel: fbank, Δ, ΔΔ, ΔΔΔ). Output: framewise CTC logits ``[B, T, vocab]``
in f32. Time stride is 1 throughout. In train mode, dropout at
``dropout_rate`` follows each dense PReLU (``qasr/models/qcnn.py:279-280``);
there is no conv dropout, as in every preset.

Layer order, as in the JAX encoder: thin conv(s) in the packed layout, each
with its split PReLU; a frequency-only ``(1, pool)`` VALID max-pool after
``pool_after`` layers; then every post-pool layer that the stacked kernels
support runs in the component-stacked F-major layout ``[B, 4, F, T, C]``:
one transpose in, each layer ``bias + qconv(prelu_prev(x))`` in the scheme
the op variant names (the previous layer's PReLU fused into the conv's
prologue), the last PReLU in torch, and one transpose out to
``[B, T, 4*F*C]``; then the quaternion dense layers with their PReLUs and
the real output layer. Under ``use_pallas`` every conv stays packed (the
wide ones on slice-im2col and the 10-product GEMM) and the dense layers take
the 10-product GEMM too.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from qasr_torch.models.layers import (
    Conv,
    Dense,
    Dropout,
    PReLU,
    QConv,
    QDense,
    flatten_quaternion,
    stacked_to_tf_packed,
    tf_packed_to_stacked,
)
from qasr_torch.ops.initializers import lecun_normal
from qasr_torch.ops.kernels import qconv_ft


# op_variant -> the scheme of the stacked layers, or None where every layer
# stays packed on the block path (qasr/models/qcnn.py:64-80 and
# layers.py:179-204, 255; stacked8g is the rank-8 products in one grouped
# XLA dispatch, the same arithmetic as kernels A and C)
CONV_SCHEMES = {
    "auto": "fast8", "stacked8": "fast8", "fused8": "fast8", "fusedchain8": "fast8",
    "stacked8g": "fast8",
    "stacked": "fast10", "fused": "fast10", "fusedchain": "fast10",
    "block": None,
}
# the packed XLA conv arms of qasr/models/layers.py:116-153, not ported
UNPORTED_CONV_VARIANTS = ("fast", "fast10", "fast8", "legacy_auto")


def conv_scheme(op_variant: str, use_pallas: bool = False) -> str | None:
    """The scheme of a qcnn tower's stacked layers for ``op_variant``
    (``"fast8"`` or ``"fast10"``), or None when every layer stays packed:
    ``use_pallas`` (the im2col GEMM, ``qcnn.py:75-80``) or ``"block"``.
    Raises ``NotImplementedError`` for the packed XLA arms and
    ``ValueError`` for a value the JAX package does not know."""
    if op_variant in UNPORTED_CONV_VARIANTS:
        raise NotImplementedError(
            f"op_variant={op_variant!r} (the packed XLA conv arms) is not ported yet "
            "(ROADMAP.md Queue 1 item 3)"
        )
    if op_variant not in CONV_SCHEMES:
        raise ValueError(
            f"unknown op_variant {op_variant!r} for arch='qcnn' (choose "
            f"{' | '.join([*CONV_SCHEMES, *UNPORTED_CONV_VARIANTS])})"
        )
    return None if use_pallas else CONV_SCHEMES[op_variant]


def stacked_routing(
    conv_features: Sequence[int],
    kernel_size: tuple[int, int],
    pool_after: int,
    cin: int = 1,
    *,
    op_variant: str = "auto",
    use_pallas: bool = False,
) -> list[bool]:
    """Which conv layers run in the stacked layout: none when
    :func:`conv_scheme` keeps every layer packed, else the post-pool layers
    that the stacked kernels' ``supported()`` admits. The port keeps its own
    channel gate: the TPU's ``>= 128`` quaternion channels
    (``qcnn.py:87-98``) filled its matrix unit's 128 lanes, while the port's
    kernels take any multiple of 8 channels."""
    if conv_scheme(op_variant, use_pallas) is None:
        return [False] * len(conv_features)
    out = []
    for i, feats in enumerate(conv_features):
        out.append(
            i >= pool_after
            and len(kernel_size) == 2
            and qconv_ft.supported(cin, feats, kernel_size, "SAME", None)
        )
        cin = feats
    return out


def freq_max_pool(x: torch.Tensor, pool_size: int) -> torch.Tensor:
    """Max-pool ``[B, T, F, C]`` over frequency only, ``(1, pool_size)``
    VALID (time resolution feeds CTC)."""
    return F.max_pool2d(
        x.permute(0, 3, 1, 2), kernel_size=(1, pool_size), stride=(1, pool_size)
    ).permute(0, 2, 3, 1)


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
            x = freq_max_pool(x, pool_size)
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
        *,
        op_variant: str = "auto",
        use_pallas: bool = False,
        **common,
    ) -> int:
        """Add the conv layers, routed as :func:`stacked_routing` and
        :func:`conv_scheme` say for ``op_variant`` and ``use_pallas``;
        returns the quaternion width ``F * C`` that the tower hands on."""
        self.pool_after = pool_after
        self.pool_size = pool_size
        self.conv_scheme = conv_scheme(op_variant, use_pallas)
        self.stacked = stacked_routing(
            conv_features, kernel_size, pool_after, op_variant=op_variant, use_pallas=use_pallas
        )
        device = common["device"]
        cin, f = 1, n_feats
        for i, feats in enumerate(conv_features):
            layout = "stacked_ft" if self.stacked[i] else "btfc"
            self.add_module(
                f"qconv_{i}",
                QConv(cin, feats, kernel_size, layout=layout, scheme=self.conv_scheme or "fast8",
                      use_pallas=use_pallas, **common),
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

    ``op_variant`` and ``use_pallas`` route the conv tower
    (:func:`conv_scheme`, :func:`stacked_routing`); ``dense_scheme`` picks
    the dense layers' GEMM (``"fast8"``: kernel B; ``"fast10"``: kernels H
    and I). ``qasr_torch.models.build_model`` maps a config onto them.
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
        op_variant: str = "auto",
        use_pallas: bool = False,
        dense_scheme: str = "fast8",
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        super().__init__()
        self.dtype = dtype
        common = dict(dtype=dtype, generator=generator, device=device)
        k = self._build_tower(n_feats, conv_features, kernel_size, pool_after, pool_size,
                              op_variant=op_variant, use_pallas=use_pallas, **common)
        self.n_dense = len(dense_features)
        self.dense_scheme = dense_scheme
        for i, feats in enumerate(dense_features):
            self.add_module(f"qdense_{i}", QDense(k, feats, scheme=dense_scheme, **common))
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


class RealCNNEncoder(nn.Module):
    """Real-valued CNN baseline at equal feature-map count (counterpart of
    ``qasr/models/qcnn.py:RealCNNEncoder``, config 3 ``timit_real_cnn``):
    the QCNN's topology with ordinary real convs and dense layers of
    ``4 * features`` channels, so 4x the quaternion model's parameters.

    The JAX package runs it on plain XLA, so the port runs it on cuDNN convs
    and cuBLAS GEMMs: it has no kernel of its own. Input ``[B, T, F, 4]``
    (the four quaternion components are conv_0's four input channels),
    channels-last throughout the tower: SAME 2-D convs over (T, F), each
    with its PReLU; the frequency-only ``(1, pool_size)`` VALID max-pool
    after ``pool_after`` layers; the flatten ``[B, T, F*C]`` (index
    ``f*C + c``); the dense layers with their PReLUs and dropout; the real
    output layer. Every conv and dense kernel, the output head's too, is
    flax's default lecun-normal, every bias zero. Parameters keep the JAX
    names and shapes (``docs/checkpoint_layout.md``): ``conv_<i>.kernel
    [kh, kw, Cin, Cout]``, ``conv_<i>.bias``, ``conv_prelu_<i>.alpha``,
    ``dense_<i>.kernel [In, Out]``, ``dense_<i>.bias``,
    ``dense_prelu_<i>.alpha``, ``output.kernel``, ``output.bias``.
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
        self.pool_after = pool_after
        self.pool_size = pool_size
        self.n_conv = len(conv_features)
        self.n_dense = len(dense_features)
        common = dict(dtype=dtype, generator=generator, device=device)
        cin, f = 4, n_feats
        for i, feats in enumerate(conv_features):
            self.add_module(f"conv_{i}", Conv(cin, 4 * feats, kernel_size, **common))
            self.add_module(f"conv_prelu_{i}", PReLU(4 * feats, device=device))
            if i + 1 == pool_after:
                f = (f - pool_size) // pool_size + 1
            cin = 4 * feats
        k = f * cin
        for i, feats in enumerate(dense_features):
            self.add_module(f"dense_{i}", Dense(k, 4 * feats, kernel_init=lecun_normal, **common))
            self.add_module(f"dense_prelu_{i}", PReLU(4 * feats, device=device))
            self.add_module(f"dense_dropout_{i}", Dropout(dropout_rate))
            k = 4 * feats
        self.output = Dense(k, vocab, kernel_init=lecun_normal, **common)

    def forward(
        self,
        x: torch.Tensor,
        *,
        lengths: torch.Tensor | None = None,
        plain: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``x [B, T, F, 4]`` -> logits ``[B, T, vocab]`` f32. In train mode
        the dropout masks come from ``generator`` (on x's device).
        ``lengths`` is accepted and unused (the model is frame-local, as the
        JAX encoder's); so is ``plain``, as there is no kernel to swap."""
        del lengths, plain
        if x.ndim != 4:
            raise ValueError(f"expected [B, T, F, 4] input, got {tuple(x.shape)}")
        x = x.to(self.dtype)
        for i in range(self.n_conv):
            x = getattr(self, f"conv_prelu_{i}")(getattr(self, f"conv_{i}")(x))
            if i + 1 == self.pool_after:
                x = freq_max_pool(x, self.pool_size)
        b, t = x.shape[:2]
        x = x.reshape(b, t, -1)
        for i in range(self.n_dense):
            x = getattr(self, f"dense_prelu_{i}")(getattr(self, f"dense_{i}")(x))
            x = getattr(self, f"dense_dropout_{i}")(x, generator)
        return self.output(x).float()
