"""Model construction from a ``Config`` (counterpart of
``qasr/train/state.py:build_model``).

Routing: every value of ``op_variant``, ``dense_variant`` and ``use_pallas``
that the JAX package takes routes to a ported path computing the JAX
route's function; a value the JAX package does not know raises
``ValueError``. Kernels: A/C
the rank-8 stacked conv and its transpose, F/G the 10-product ones, B the
rank-8 GEMM, H/I the 10-product GEMM and its dW, D/E the QLSTM recurrence
and its backward.

``arch="qcnn"`` (``qasr/models/qcnn.py:64-80``, ``layers.py:107-153,
179-256, 311-339``):

======================================  =====================================
``op_variant``                          conv tower
======================================  =====================================
auto, stacked8, fused8, fusedchain8     post-pool layers stacked in the
                                        rank-8 scheme (A, C); the rest packed
                                        on the block path (cuDNN on the
                                        expanded kernel)
stacked8g                               as auto: the grouped dispatch is
                                        XLA's form of the same rank-8
                                        products
stacked, fused, fusedchain              post-pool layers stacked in the
                                        10-product scheme (F, G); the rest
                                        on the block path
block                                   every layer packed, block path
fast, fast10, fast8                     every layer packed on that arm:
                                        ``qconv_fast`` (one grouped cuDNN
                                        conv of 10 groups), ``qconv_fast10``
                                        / ``qconv_fast8`` (10 / 8 cuDNN convs
                                        of the input combos); no conv kernel
legacy_auto                             every layer packed: ``fast10`` where
                                        ``min(Cin, features) >= 128``, else
                                        the block path
======================================  =====================================

The port's stacked layers are those its kernels take (post-pool, channels a
multiple of 8), not the TPU's ``>= 128`` (``qcnn.stacked_routing``).
``use_pallas=True`` keeps every layer packed, whatever ``op_variant`` says
of the stack: layers with ``Cin * kh * kw >= 32`` run slice-im2col and the
10-product GEMM (H, I), the others their packed arm (the block path, or
the packed XLA arm ``op_variant`` names). Dense layers:

==========================================  =================================
``dense_variant``                           dense layers
==========================================  =================================
pallas (or ``use_pallas``), fast            the 10-product GEMM (H, I): fast
                                            is XLA's form of the same scheme
auto, block, fast8, pallas8, fast8_stacked  the rank-8 GEMM (B): the same
                                            quaternion dense (fast8_stacked
                                            is its rank-8 form fed from the
                                            conv stack, after one exit
                                            transpose)
==========================================  =================================

``arch="qlstm"`` (``qasr/train/state.py:68-138``): ``op_variant`` routes the
input projections and the recurrence, as :func:`qlstm_routing` says:

======================  ====================  ===============================
``op_variant``          input projection      recurrence
======================  ====================  ===============================
block                   block product         block
fast8                   kernel B              block
auto, fast8_recurrent   by rows: the block    kernel D where it applies (CUDA,
                        product from          bidirectional, and
                        ``BLOCK_ROWS``,       ``qlstm_scan.supported``), else
                        kernel B below        the plain fast8 loop
pallas8                 kernel B              kernel D where it applies, else
                                              the plain fast8 loop;
                                              unidirectional: ``ValueError``
======================  ====================  ===============================

``bidirectional=False`` builds ``QLSTMLayer``s, which never run kernel D
(``auto`` and ``fast8_recurrent`` take the fast8 loop, as the JAX package
does). The conv tower runs the ``auto`` routing, as the JAX encoder's does;
``use_pallas=True`` keeps the tower packed (im2col GEMM where it applies) and
puts the dense layers on the 10-product GEMM (``qasr/models/qlstm.py:338,
370``); ``dense_variant`` is not read, as the JAX encoder does not read it
(any value it takes is accepted).

``arch="real_cnn"`` (``qasr/train/state.py:57-67``) and ``arch="real_lstm"``
(``:139-153``): the real-CNN baseline and config 4's real CNN-LSTM ablation,
on cuDNN convs and cuBLAS products, as the JAX package runs them on plain
XLA; ``op_variant``, ``dense_variant`` and ``use_pallas`` are not read, as
the JAX ``build_model`` does not pass them.
"""

from __future__ import annotations

import torch
from torch import nn

from qasr_torch.configs import Config
from qasr_torch.configs.config import ModelConfig
from qasr_torch.models.qcnn import QCNNEncoder, RealCNNEncoder, conv_scheme
from qasr_torch.models.qlstm import QLSTMEncoder, RealLSTMEncoder
from qasr_torch.ops.kernels import qlstm_scan

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_QLSTM_VARIANTS = ("auto", "block", "fast8", "fast8_recurrent", "pallas8")
# dense_variant -> the dense layers' scheme (see the module docstring)
_DENSE_SCHEMES = {
    "pallas": "fast10", "fast": "fast10",
    "auto": "fast8", "block": "fast8", "fast8": "fast8", "pallas8": "fast8",
    "fast8_stacked": "fast8",
}


def dense_scheme(m: ModelConfig) -> str:
    """The dense layers' scheme of a qcnn model: ``"fast10"`` (kernels H and
    I) or ``"fast8"`` (kernel B), as the module docstring's table says."""
    if m.dense_variant not in _DENSE_SCHEMES:
        raise ValueError(
            f"unknown dense_variant {m.dense_variant!r} (choose {' | '.join(_DENSE_SCHEMES)})"
        )
    return "fast10" if m.use_pallas else _DENSE_SCHEMES[m.dense_variant]


def qlstm_routing(m: ModelConfig, device: torch.device | str) -> tuple[str, str]:
    """``(input_proj, recurrent)`` of a qlstm model on ``device``, as
    ``qasr/train/state.py:68-138`` routes it (the module docstring's
    table): ``"block"`` is the block product and recurrence, ``"fast8"``
    kernel B into the block recurrence; ``"auto"``, ``"fast8_recurrent"``
    and ``"pallas8"`` run the recurrence on kernel D where the device is
    CUDA, the layers are bidirectional and ``qlstm_scan.supported`` admits
    the hidden size and dtype on that card's SMs, and on the plain
    ``"fast8"`` loop otherwise; ``"pallas8"`` also puts every input
    projection on kernel B (the others route it by row count), and a
    unidirectional ``"pallas8"`` keeps kernel D's name, which
    ``QLSTMLayer`` refuses."""
    if m.op_variant not in _QLSTM_VARIANTS:
        raise ValueError(
            f"op_variant {m.op_variant!r} is not valid for arch='qlstm' "
            "(choose auto | block | fast8 | fast8_recurrent | pallas8)"
        )
    if m.op_variant in ("block", "fast8"):
        return m.op_variant, "block"
    input_proj = "pallas8" if m.op_variant == "pallas8" else "auto"
    if not m.bidirectional:
        return input_proj, ("pallas8" if m.op_variant == "pallas8" else "fast8")
    on_card = torch.device(device).type == "cuda"
    kernel = on_card and qlstm_scan.supported(
        m.lstm_features, _DTYPES[m.compute_dtype], qlstm_scan.device_sms(device)
    )
    return input_proj, ("pallas8" if kernel else "fast8")


def build_model(
    cfg: Config,
    *,
    generator: torch.Generator | None = None,
    device: torch.device | str = "cuda",
    train: bool = False,
) -> nn.Module:
    """The encoder for ``cfg``, its weights drawn from ``generator`` (the
    port's init) on ``device`` (the GPU unless the caller asks for the CPU),
    in train mode (dropout at ``cfg.model.dropout_rate``) or eval mode.

    Every arch (``qcnn``, ``qlstm``, ``real_cnn``, ``real_lstm``) serves and
    trains, routed as the module docstring says in both modes.
    """
    m = cfg.model
    dtype = _DTYPES[m.compute_dtype]
    if m.arch == "qcnn":
        conv_scheme(m.op_variant, m.use_pallas)  # raises on an unknown arm
        return QCNNEncoder(
            n_feats=cfg.data.n_mels,
            conv_features=tuple(m.conv_features),
            dense_features=tuple(m.dense_features),
            vocab=m.vocab,
            kernel_size=tuple(m.kernel_size),
            pool_after=m.pool_after,
            pool_size=m.pool_size,
            dropout_rate=m.dropout_rate,
            op_variant=m.op_variant,
            use_pallas=m.use_pallas,
            dense_scheme=dense_scheme(m),
            dtype=dtype,
            generator=generator,
            device=device,
        ).train(train)
    if m.arch == "qlstm":
        input_proj, recurrent = qlstm_routing(m, device)
        dense_scheme(m)  # a value the JAX package does not know raises
        # the JAX build_model gives QLSTMEncoder no kernel_size: it is (3, 3)
        return QLSTMEncoder(
            n_feats=cfg.data.n_mels,
            conv_features=tuple(m.conv_features),
            dense_features=tuple(m.dense_features),
            lstm_features=m.lstm_features,
            lstm_layers=m.lstm_layers,
            bidirectional=m.bidirectional,
            vocab=m.vocab,
            pool_after=m.pool_after,
            pool_size=m.pool_size,
            dropout_rate=m.dropout_rate,
            dtype=dtype,
            input_proj=input_proj,
            recurrent=recurrent,
            use_pallas=m.use_pallas,
            generator=generator,
            device=device,
        ).train(train)
    if m.arch == "real_cnn":
        return RealCNNEncoder(
            n_feats=cfg.data.n_mels,
            conv_features=tuple(m.conv_features),
            dense_features=tuple(m.dense_features),
            vocab=m.vocab,
            kernel_size=tuple(m.kernel_size),
            pool_after=m.pool_after,
            pool_size=m.pool_size,
            dropout_rate=m.dropout_rate,
            dtype=dtype,
            generator=generator,
            device=device,
        ).train(train)
    if m.arch == "real_lstm":
        # the JAX build_model gives RealLSTMEncoder no kernel_size: it is (3, 3)
        return RealLSTMEncoder(
            n_feats=cfg.data.n_mels,
            conv_features=tuple(m.conv_features),
            dense_features=tuple(m.dense_features),
            lstm_features=m.lstm_features,
            lstm_layers=m.lstm_layers,
            bidirectional=m.bidirectional,
            vocab=m.vocab,
            pool_after=m.pool_after,
            pool_size=m.pool_size,
            dropout_rate=m.dropout_rate,
            dtype=dtype,
            generator=generator,
            device=device,
        ).train(train)
    raise ValueError(f"unknown arch {m.arch!r} (choose qcnn | real_cnn | qlstm | real_lstm)")
