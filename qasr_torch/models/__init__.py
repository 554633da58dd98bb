"""Model construction from a ``Config`` (counterpart of
``qasr/train/state.py:build_model``)."""

from __future__ import annotations

import torch

from qasr_torch.configs import Config
from qasr_torch.models.qcnn import QCNNEncoder

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(
    cfg: Config,
    *,
    generator: torch.Generator | None = None,
    device: torch.device | str = "cuda",
    train: bool = False,
) -> QCNNEncoder:
    """The encoder for ``cfg``, its weights drawn from ``generator`` (the
    port's init) on ``device`` (the GPU unless the caller asks for the CPU),
    in train mode (dropout at ``cfg.model.dropout_rate``) or eval mode.

    Only ``arch="qcnn"`` is ported so far.
    """
    m = cfg.model
    if m.arch != "qcnn":
        raise NotImplementedError(
            f"arch={m.arch!r} is not ported yet (ROADMAP.md Queue 1: "
            "real_cnn is item 6, qlstm is item 13)"
        )
    return QCNNEncoder(
        n_feats=cfg.data.n_mels,
        conv_features=tuple(m.conv_features),
        dense_features=tuple(m.dense_features),
        vocab=m.vocab,
        kernel_size=tuple(m.kernel_size),
        pool_after=m.pool_after,
        pool_size=m.pool_size,
        dropout_rate=m.dropout_rate,
        dtype=_DTYPES[m.compute_dtype],
        generator=generator,
        device=device,
    ).train(train)
