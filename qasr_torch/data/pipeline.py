"""Corpus -> quaternion features on the device -> cached or streamed examples
(counterpart of ``qasr/data/pipeline.py``).

Waveforms are featurized by the port's front end (``qasr_torch.features``:
log-mel FBANK + Δ, ΔΔ, ΔΔΔ, per-utterance normalization) in padded blocks on
``device`` (the GPU unless the caller asks for the CPU), then either

* **cached**: one ``.npz`` per split (the JAX package's key and layout, so a
  cache written by either package loads in the other), read on every later
  build; or
* **streamed** (``cache_features=False``): featurized on demand. The batching
  layer announces the epoch order ahead of consumption, so ``prefetch``
  featurizes a block of upcoming utterances in one dispatch and
  ``__getitem__`` pops it.

A block pads to its longest waveform: the deltas clamp at each utterance's
own last frame and the normalization counts valid frames only, so the
features do not depend on the padding (the JAX package pads to powers of two
for its compiler; torch needs no bounded set of shapes). On a CUDA device the
featurization runs on a stream of its own, so that a producer thread
(``qasr_torch.data.batching.Prefetcher``) featurizing the next block does not
wait behind the train step queued on the default stream.

``FeaturePipeline`` takes any corpus with ``load(i) -> (wav, ids)`` and
``__len__``; ``TimitFeaturePipeline`` and ``LibriFeaturePipeline`` bind it to
the two corpora under ``cfg.data.data_dir``.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading

import numpy as np
import torch

from qasr_torch.configs import Config
from qasr_torch.features.frontend import (
    FrontendConfig,
    normalize_features,
    num_frames,
    quaternion_features,
)


class _FeatureExample:
    __slots__ = ("features", "labels", "num_frames", "num_labels")

    def __init__(self, features, labels):
        self.features = features
        self.labels = labels
        self.num_frames = features.shape[0]
        self.num_labels = len(labels)


def _obj_array(items) -> np.ndarray:
    """A 1-D object array of ``items``, filled item by item: ``np.array(...,
    dtype=object)`` would broadcast same-shaped arrays into a 2-D one."""
    arr = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        arr[i] = x
    return arr


class FeaturePipeline:
    """Dataset of (quaternion features ``[T, F, 4]`` f32, label ids ``[L]``
    int32) examples, as numpy arrays."""

    def __init__(
        self,
        corpus,
        cfg: Config,
        *,
        cache_key: str,
        cache_dir: str,
        featurize_batch: int = 32,
        cache_features: bool | None = None,
        device: torch.device | str = "cuda",
    ):
        self.cfg = cfg
        self.corpus = corpus
        self.device = torch.device(device)
        self.fcfg = FrontendConfig(sample_rate=cfg.data.sample_rate, n_mels=cfg.data.n_mels)
        if cache_features is None:
            cache_features = cfg.data.cache_features
        # the JAX package's key: a cache written by either package loads in
        # the other (v2: length-aware delta clamping)
        key = hashlib.sha1(
            f"{cache_key}:{cfg.data.n_mels}:{cfg.data.sample_rate}:v2".encode()
        ).hexdigest()[:12]
        self.cache_path = os.path.join(cache_dir, f"feats_{key}.npz")
        self.cache_hit = False  # whether the examples were read from cache_path
        self._featurize_batch = featurize_batch
        self._stream_cache: dict[int, _FeatureExample] = {}
        self._lock = threading.Lock()
        self._cuda_stream = None
        if cache_features:
            self._examples = self._load_or_build()
        else:
            self._examples = None  # streaming: featurize in prefetch / __getitem__

    def featurize(self, loaded) -> list[_FeatureExample]:
        """(waveform ``[N]`` f32, labels) pairs -> examples, in one padded
        batch on ``self.device``."""
        fcfg = self.fcfg
        width = max(max(len(w) for w, _ in loaded), fcfg.win_length)
        batch = np.zeros((len(loaded), width), np.float32)
        lens = np.zeros((len(loaded),), np.int64)
        for j, (w, _) in enumerate(loaded):
            batch[j, : len(w)] = w
            lens[j] = num_frames(len(w), fcfg)
        if self.device.type == "cuda" and self._cuda_stream is None:
            self._cuda_stream = torch.cuda.Stream(device=self.device)
        ctx = (torch.cuda.stream(self._cuda_stream) if self._cuda_stream is not None
               else contextlib.nullcontext())
        with ctx, torch.no_grad():
            x = torch.from_numpy(batch).to(self.device)
            t = torch.from_numpy(lens).to(self.device)
            feats = normalize_features(quaternion_features(x, fcfg, t), t).cpu().numpy()
        out = []
        for j, (_, lab) in enumerate(loaded):
            n = int(lens[j])
            # packed [T, 4*n_mels] -> [T, F, 4], the layout the encoders take
            f = np.moveaxis(feats[j, :n].reshape(n, 4, fcfg.n_mels), 1, 2)
            out.append(_FeatureExample(f.copy(), np.asarray(lab)))
        return out

    def _load_or_build(self) -> list[_FeatureExample]:
        if os.path.exists(self.cache_path):
            data = np.load(self.cache_path, allow_pickle=True)
            self.cache_hit = True
            return [
                _FeatureExample(np.asarray(f, np.float32), np.asarray(l, np.int32))
                for f, l in zip(data["features"], data["labels"])
            ]
        examples = []
        n = len(self.corpus)
        for start in range(0, n, self._featurize_batch):
            idxs = range(start, min(start + self._featurize_batch, n))
            examples += self.featurize([self.corpus.load(i) for i in idxs])
        os.makedirs(os.path.dirname(self.cache_path), exist_ok=True)
        # write then rename: a killed build never leaves a truncated cache
        tmp = f"{self.cache_path}.tmp-{os.getpid()}.npz"
        np.savez_compressed(
            tmp,
            features=_obj_array([e.features for e in examples]),
            labels=_obj_array([e.labels for e in examples]),
        )
        os.replace(tmp, self.cache_path)
        return examples

    def prefetch(self, indices) -> None:
        """Streaming mode: featurize the upcoming utterances ``indices`` in
        blocks of ``featurize_batch``, one dispatch a block; ``__getitem__``
        pops them (at most one announced block stays resident). A cached
        pipeline ignores it."""
        if self._examples is not None:
            return
        with self._lock:
            todo = [int(i) for i in indices if int(i) not in self._stream_cache]
            for start in range(0, len(todo), self._featurize_batch):
                chunk = todo[start : start + self._featurize_batch]
                feats = self.featurize([self.corpus.load(i) for i in chunk])
                self._stream_cache.update(zip(chunk, feats))

    def __len__(self):
        return len(self.corpus) if self._examples is None else len(self._examples)

    def __getitem__(self, i) -> _FeatureExample:
        if self._examples is not None:
            return self._examples[i]
        with self._lock:
            ex = self._stream_cache.pop(int(i), None)
            return ex if ex is not None else self.featurize([self.corpus.load(int(i))])[0]


class TimitFeaturePipeline(FeaturePipeline):
    """A TIMIT split (``qasr_torch.data.timit.TimitDataset``) of
    ``cfg.data.data_dir``; the cache defaults to ``<root>/.qasr_cache``."""

    def __init__(self, cfg: Config, split: str = "train", **kw):
        from qasr_torch.data.timit import TimitDataset

        root = cfg.data.data_dir
        super().__init__(
            TimitDataset(root, split),
            cfg,
            cache_key=f"timit_{split}",
            cache_dir=kw.pop("cache_dir", None) or os.path.join(root, ".qasr_cache"),
            **kw,
        )


class LibriFeaturePipeline(FeaturePipeline):
    """A LibriSpeech split directory (``qasr_torch.data.librispeech.
    LibriSpeechDataset``) of ``cfg.data.data_dir``; the cache defaults to
    ``<root>/.qasr_cache``."""

    def __init__(self, cfg: Config, split: str = "train-clean-100", **kw):
        from qasr_torch.data.librispeech import LibriSpeechDataset

        root = cfg.data.data_dir
        super().__init__(
            LibriSpeechDataset(root, split),
            cfg,
            cache_key=f"libri_{split}",
            cache_dir=kw.pop("cache_dir", None) or os.path.join(root, ".qasr_cache"),
            **kw,
        )
