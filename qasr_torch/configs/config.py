"""Typed config tree with the named presets (the port's own copy of
``qasr/configs/config.py``; a test holds the two equal).

One frozen dataclass tree (model/data/train/mesh/decode), named presets, CLI
overrides via ``--key.subkey=value``, and JSON serialization into every
checkpoint directory: ``Config.from_json`` reads the ``config.json`` that
either package's training writes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    arch: str = "qcnn"  # qcnn | real_cnn | qlstm
    conv_features: tuple[int, ...] = (32, 32, 64, 64, 64, 64, 64, 64, 64, 64)
    dense_features: tuple[int, ...] = (256, 256, 256)
    vocab: int = 62
    kernel_size: tuple[int, int] = (3, 3)
    pool_after: int = 1
    pool_size: int = 3
    dropout_rate: float = 0.3
    lstm_features: int = 0        # quaternion LSTM hidden size (qlstm arch)
    lstm_layers: int = 0
    bidirectional: bool = True
    compute_dtype: str = "float32"  # float32 | bfloat16
    use_pallas: bool = False
    # the JAX package's conv and dense path switches; the port routes by
    # shape (qasr_torch.models.qcnn.stacked_routing) and keeps them only so
    # that configs round-trip between the packages
    op_variant: str = "auto"
    dense_variant: str = "auto"


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"    # synthetic | timit | librispeech
    data_dir: str = ""
    n_mels: int = 40
    sample_rate: int = 16000
    max_label_len: int = 64
    batch_size: int = 8            # global batch (across all DP shards)
    num_synthetic: int = 64        # synthetic dataset size
    bucket_sizes: tuple[int, ...] = (64, 128, 256)
    prefetch_depth: int = 2        # background host-side batch prefetch queue
    cache_features: bool = True    # False: featurize per utterance on demand


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    num_steps: int = 1000
    warmup_steps: int = 100
    eval_every: int = 200
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/qasr_ckpt"
    keep_checkpoints: int = 3
    log_every: int = 20
    remat_convs: bool = False      # jax.checkpoint over conv stack
    debug_nans: bool = False       # run the loop under utils.debug.nan_debug


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh: data axis for DP over ICI, model axis for TP sharding of
    quaternion output channels.

    ``data_axis == -1`` means "all devices remaining after the model axis"
    (the model axis is clamped down to the largest divisor of the device count
    so presets run anywhere). An explicit ``data_axis`` pins the DP extent and
    the mesh takes exactly ``data_axis * model_axis`` devices — fewer than the
    slice is allowed (a deliberate subset run), more raises."""

    data_axis: int = -1            # -1: all devices / explicit DP extent
    model_axis: int = 1


@dataclass(frozen=True)
class DecodeConfig:
    blank_id: int = 0
    beam_width: int = 16
    # emission-pruning threshold for the prefix beam (nats below the frame
    # max); None = no pruning. The TIMIT presets set -20.0.
    beam_prune_logp: float | None = None


@dataclass(frozen=True)
class Config:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        return _from_dict(Config, json.loads(s))

    def override(self, **flat: Any) -> "Config":
        """Apply dotted-path overrides, e.g. ``override(**{"train.num_steps": 5})``."""
        cfg = self
        for path, value in flat.items():
            cfg = _set_path(cfg, path.split("."), value)
        return cfg


def _field_types(cls):
    import typing

    return typing.get_type_hints(cls)


def _from_dict(cls, d):
    if not dataclasses.is_dataclass(cls):
        return d
    hints = _field_types(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            kwargs[f.name] = _from_dict(ftype, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(tuple(e) if isinstance(e, list) else e for e in v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def _coerce(ftype, value):
    import types
    import typing

    if not isinstance(value, str):
        return value
    if typing.get_origin(ftype) in (typing.Union, types.UnionType):
        # Optional[T] fields (e.g. beam_prune_logp: float | None): "none" /
        # "null" map to None, anything else coerces as the non-None member
        if value.strip().lower() in ("none", "null"):
            return None
        members = [a for a in typing.get_args(ftype) if a is not type(None)]
        if len(members) == 1:
            return _coerce(members[0], value)
        return value
    if ftype is bool:
        return value.lower() in ("1", "true", "yes")
    if ftype in (int, float):
        return ftype(value)
    if typing.get_origin(ftype) is tuple:
        # tuple-typed field: "64", "128,128", "(64,128)" and "[64,128]" all
        # become tuples (the comma test alone left single-element tuples as
        # bare strings, and unstripped parens silently produced string items)
        s = value.strip()
        if len(s) >= 2 and s[0] in "([" and s[-1] in ")]":
            s = s[1:-1]
        return tuple(
            int(x) if x.lstrip("-").isdigit() else x
            for x in (part.strip() for part in s.split(","))
            if x != ""
        )
    return value


def _set_path(obj, path, value):
    if len(path) == 1:
        ftype = _field_types(type(obj)).get(path[0])
        return dataclasses.replace(obj, **{path[0]: _coerce(ftype, value)})
    child = getattr(obj, path[0])
    return dataclasses.replace(obj, **{path[0]: _set_path(child, path[1:], value)})


# ---------------------------------------------------------------------------
# Named presets, as in the JAX package: five configs plus the paper's
# feature-map sweep (uniform feature maps {32,64,128,256} over ~10 conv
# layers; `timit_qcnn` is the largest = the paper's best TIMIT model,
# QCNN-256).
# ---------------------------------------------------------------------------


def _timit_preset(fm: int, arch: str = "qcnn", name: str | None = None) -> Config:
    return Config(
        name=name or f"timit_{arch}_fm{fm}",
        model=ModelConfig(
            arch=arch,
            conv_features=(fm,) * 10,
            dense_features=(256, 256, 256),
            vocab=62,
            compute_dtype="bfloat16",
        ),
        data=DataConfig(
            dataset="timit", max_label_len=80, batch_size=16,
            bucket_sizes=(128, 256, 384, 512),
        ),
        train=TrainConfig(num_steps=40000, warmup_steps=500),
        # beam width 100 = Keras K.ctc_decode(greedy=False)'s default; -20
        # nats emission pruning is the TIMIT protocol setting
        decode=DecodeConfig(beam_width=100, beam_prune_logp=-20.0),
    )


PRESETS: dict[str, Config] = {
    # 1. Small QCNN (2 quaternion conv + dense + CTC), CPU-runnable smoke
    "tiny_synthetic": Config(
        name="tiny_synthetic",
        model=ModelConfig(
            conv_features=(8, 8),
            dense_features=(32,),
            vocab=12,
            dropout_rate=0.0,
        ),
        data=DataConfig(
            dataset="synthetic",
            n_mels=8,
            max_label_len=8,
            batch_size=8,
            num_synthetic=64,
            bucket_sizes=(64,),
        ),
        train=TrainConfig(num_steps=300, warmup_steps=20, learning_rate=3e-3),
    ),
    # 2. Full reference QCNN stack on TIMIT (the paper's best model,
    # QCNN-256), prefix beam decode
    "timit_qcnn": _timit_preset(256, name="timit_qcnn"),
    # 3. Quaternion-vs-real ablation at equal feature maps (kernel compare)
    "timit_real_cnn": _timit_preset(256, arch="real_cnn", name="timit_real_cnn"),
    # The paper's model-size sweep (both architectures)
    **{f"timit_qcnn_fm{fm}": _timit_preset(fm) for fm in (32, 64, 128)},
    **{
        f"timit_real_cnn_fm{fm}": _timit_preset(fm, arch="real_cnn")
        for fm in (32, 64, 128)
    },
    # 4. QCNN-LSTM hybrid on LibriSpeech-100h
    "librispeech_qlstm": Config(
        name="librispeech_qlstm",
        model=ModelConfig(
            arch="qlstm",
            conv_features=(64, 64, 128, 128),
            dense_features=(256,),
            lstm_features=256,
            lstm_layers=3,
            vocab=32,               # character vocab
            compute_dtype="bfloat16",
        ),
        data=DataConfig(
            dataset="librispeech", max_label_len=512,
            batch_size=32, bucket_sizes=(512, 1024, 2048),
        ),
        train=TrainConfig(num_steps=200000, warmup_steps=2000),
    ),
    # 5. Large sharded quaternion encoder on LibriSpeech-960h (DP x TP)
    "librispeech_large": Config(
        name="librispeech_large",
        model=ModelConfig(
            conv_features=(64, 64, 128, 128, 256, 256, 256, 256, 256, 256),
            dense_features=(1024, 1024, 1024),
            vocab=32,
            compute_dtype="bfloat16",
        ),
        data=DataConfig(
            dataset="librispeech", max_label_len=512,
            batch_size=64, bucket_sizes=(512, 1024, 2048),
            # featurize on demand (streaming mode)
            cache_features=False,
        ),
        train=TrainConfig(num_steps=500000, warmup_steps=5000),
        mesh=MeshConfig(data_axis=-1, model_axis=4),
    ),
}


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
