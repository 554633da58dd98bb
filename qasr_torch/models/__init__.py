"""Model construction from a ``Config`` (counterpart of
``qasr/train/state.py:build_model``)."""

from __future__ import annotations

import torch
from torch import nn

from qasr_torch.configs import Config
from qasr_torch.configs.config import ModelConfig
from qasr_torch.models.qcnn import QCNNEncoder
from qasr_torch.models.qlstm import QLSTMEncoder
from qasr_torch.ops.kernels import qlstm_scan

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_QLSTM_VARIANTS = ("auto", "block", "fast8", "fast8_recurrent", "pallas8")


def qlstm_routing(m: ModelConfig, device: torch.device | str) -> tuple[str, str]:
    """``(input_proj, recurrent)`` of a qlstm model on ``device``, as
    ``qasr/train/state.py:68-138`` routes it: ``"auto"``,
    ``"fast8_recurrent"`` and ``"pallas8"`` run the recurrence on kernel D
    where the device is CUDA, the layers are bidirectional and
    ``qlstm_scan.supported`` admits the hidden size and dtype on that card's
    SMs, and on the
    plain ``"fast8"`` loop otherwise. ``"pallas8"`` also puts every input
    projection on kernel B; the others route it by row count."""
    if m.op_variant not in _QLSTM_VARIANTS:
        raise ValueError(
            f"op_variant {m.op_variant!r} is not valid for arch='qlstm' "
            "(choose auto | block | fast8 | fast8_recurrent | pallas8)"
        )
    if m.op_variant in ("block", "fast8"):
        raise NotImplementedError(
            f"op_variant={m.op_variant!r} (the block recurrence) is not ported yet "
            "(ROADMAP.md Queue 1 item 13)"
        )
    if not m.bidirectional:
        raise NotImplementedError(
            "the unidirectional QLSTMLayer is not ported yet (ROADMAP.md Queue 1 item 13)"
        )
    on_card = torch.device(device).type == "cuda"
    kernel = on_card and qlstm_scan.supported(
        m.lstm_features, _DTYPES[m.compute_dtype], qlstm_scan.device_sms(device)
    )
    return ("pallas8" if m.op_variant == "pallas8" else "auto"), ("pallas8" if kernel else "fast8")


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

    ``arch="qcnn"`` and ``arch="qlstm"`` serve and train; a qlstm model
    routes as :func:`qlstm_routing` says in both modes.
    """
    m = cfg.model
    dtype = _DTYPES[m.compute_dtype]
    if m.arch == "qcnn":
        return QCNNEncoder(
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
    if m.arch == "qlstm":
        input_proj, recurrent = qlstm_routing(m, device)
        # the JAX build_model gives QLSTMEncoder no kernel_size: it is (3, 3)
        return QLSTMEncoder(
            n_feats=cfg.data.n_mels,
            conv_features=tuple(m.conv_features),
            dense_features=tuple(m.dense_features),
            lstm_features=m.lstm_features,
            lstm_layers=m.lstm_layers,
            vocab=m.vocab,
            pool_after=m.pool_after,
            pool_size=m.pool_size,
            dropout_rate=m.dropout_rate,
            dtype=dtype,
            input_proj=input_proj,
            recurrent=recurrent,
            generator=generator,
            device=device,
        ).train(train)
    raise NotImplementedError(
        f"arch={m.arch!r} is not ported yet (ROADMAP.md Queue 1: real_cnn is item 6, "
        "real_lstm is item 13)"
    )
