"""Synthetic CTC-able dataset for tests/smoke runs (the port's own copy of
``qasr/data/synthetic.py``; a test holds its examples equal).

The corpora do not ship with the repo, so every stage can run on synthetic
fixtures: each vocabulary symbol gets a
fixed random spectral prototype; an utterance is a random label sequence whose
symbols are expanded to random durations, emitted as prototype + noise in the
packed quaternion feature layout ``[T, F, 4]``. A CTC model can drive loss
toward zero on this.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticExample:
    features: np.ndarray      # [T, F, 4] float32
    labels: np.ndarray        # [L] int32, values in [1, vocab)
    num_frames: int
    num_labels: int


class SyntheticDataset:
    def __init__(
        self,
        *,
        vocab: int = 12,
        n_mels: int = 8,
        num_examples: int = 64,
        min_labels: int = 2,
        max_labels: int = 8,
        min_dur: int = 3,
        max_dur: int = 8,
        noise: float = 0.1,
        seed: int = 0,
    ):
        self.vocab = vocab
        self.n_mels = n_mels
        rng = np.random.RandomState(seed)
        # one spectral prototype per non-blank symbol, in [F, 4]
        self.prototypes = rng.randn(vocab, n_mels, 4).astype(np.float32)
        self._examples = [
            self._make(rng, min_labels, max_labels, min_dur, max_dur, noise)
            for _ in range(num_examples)
        ]

    def _make(self, rng, min_l, max_l, min_d, max_d, noise) -> SyntheticExample:
        n_labels = rng.randint(min_l, max_l + 1)
        labels = rng.randint(1, self.vocab, size=n_labels).astype(np.int32)
        frames = []
        for lab in labels:
            dur = rng.randint(min_d, max_d + 1)
            proto = self.prototypes[lab]
            frames.append(
                proto[None] + noise * rng.randn(dur, self.n_mels, 4).astype(np.float32)
            )
        feat = np.concatenate(frames, axis=0)
        return SyntheticExample(feat, labels, feat.shape[0], n_labels)

    def __len__(self):
        return len(self._examples)

    def __getitem__(self, i) -> SyntheticExample:
        return self._examples[i]


def random_batch(b: int, t: int, n_mels: int, vocab: int, label_len: int, *,
                 pad_to: int | None = None, seed: int = 0) -> dict:
    """A batch of random numbers for timing and memory runs (the port's
    counterpart of ``bench.py:_make_batch``): ``features [b, t, n_mels, 4]``
    standard normal, every row ``t`` frames long, ``labels [b, pad_to]``
    (default ``label_len``) of random symbols in ``[1, vocab)`` of which the
    first ``label_len`` count; without ``pad_to`` the same arrays as the
    reference's at the same arguments."""
    rng = np.random.RandomState(seed)
    return {
        "features": rng.randn(b, t, n_mels, 4).astype(np.float32),
        "feature_lengths": np.full((b,), t, np.int32),
        "labels": rng.randint(1, vocab, size=(b, pad_to or label_len)).astype(np.int32),
        "label_lengths": np.full((b,), label_len, np.int32),
    }
