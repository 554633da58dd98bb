"""Bucketed padding + batching for CTC training (the port's own copy of
``qasr/data/batching.py`` without its prefetch thread; a test holds the
batches equal to the reference's for one seed).

Utterances are bucketed to a small set of frame ceilings, and every batch
has static shapes ``[B, T_bucket, F, 4]`` / ``[B, L_max]``. Batches are numpy
dicts; the train step moves them to the device.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

# A batch is a plain dict with keys: features [B,T,F,4], feature_lengths [B],
# labels [B,L], label_lengths [B], real_rows [B].
Batch = dict


def pick_bucket(num_frames: int, bucket_sizes: tuple[int, ...]) -> int:
    for b in bucket_sizes:
        if num_frames <= b:
            return b
    return bucket_sizes[-1]


def feasible_label_len(labels, num_frames: int) -> int:
    """Longest label prefix CTC can emit in ``num_frames`` frames.

    A prefix of length L needs L + (# adjacent equal pairs in the prefix)
    frames (each repeat forces a blank between the two emissions). Feeding an
    infeasible (T, L) pair gives the lattice zero probability mass — the loss
    saturates at the log-space floor (~1e30) and poisons the whole batch —
    so truncated utterances must clamp labels to this bound.
    """
    labels = np.asarray(labels)
    if labels.size == 0:
        return 0
    # frames needed by each prefix length 1..L (monotonically increasing)
    repeats = np.concatenate([[0], np.cumsum(labels[1:] == labels[:-1])])
    needed = np.arange(1, labels.size + 1) + repeats
    return int(np.searchsorted(needed, num_frames, side="right"))


def make_batch(
    examples: list,
    bucket: int,
    max_label_len: int,
    num_real: int | None = None,
) -> Batch:
    """Pad a list of (features [T,F,4], labels [L]) examples to static shapes.

    Features longer than the bucket and labels longer than ``max_label_len``
    are truncated; labels are additionally clamped to the CTC-feasible length
    for the (possibly truncated) frame count, with a warning — an infeasible
    pair would train on a ~1e30 loss.

    ``num_real``: number of leading rows that are real utterances. Remainder
    batches keep static batch shape by repeating a row; those pad rows carry
    ``real_rows=False`` so eval scores each utterance exactly once and the
    loss excludes them (reference protocol: every utterance scored once).
    """
    b = len(examples)
    f = examples[0][0].shape[1]
    ncomp = examples[0][0].shape[2]
    feats = np.zeros((b, bucket, f, ncomp), np.float32)
    labels = np.zeros((b, max_label_len), np.int32)
    flens = np.zeros((b,), np.int32)
    llens = np.zeros((b,), np.int32)
    clamped = 0
    for n, (x, y) in enumerate(examples):
        t = min(x.shape[0], bucket)
        l = min(len(y), max_label_len)
        feasible = feasible_label_len(y[:l], t)
        if feasible < l:
            clamped += 1
            l = feasible
        feats[n, :t] = x[:t]
        labels[n, :l] = y[:l]
        flens[n] = t
        llens[n] = l
    if clamped:
        import warnings

        warnings.warn(
            f"make_batch: clamped labels of {clamped}/{b} utterances to the "
            f"CTC-feasible length for bucket={bucket} frames (utterance longer "
            "than the top bucket?) — raise data.bucket_sizes to train on full "
            "transcripts",
            stacklevel=2,
        )
    real = np.ones((b,), bool)
    if num_real is not None:
        real[num_real:] = False
    return Batch(
        features=feats,
        feature_lengths=flens,
        labels=labels,
        label_lengths=llens,
        real_rows=real,
    )


def bucketed_batches(
    examples,  # sequence of (features, labels) pairs; lazily indexable
    *,
    batch_size: int,
    bucket_sizes: tuple[int, ...],
    max_label_len: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[Batch]:
    """Group (features, labels) pairs into same-bucket batches.

    Yields batches whose frame dim is the bucket ceiling — at most
    ``len(bucket_sizes)`` distinct shapes per epoch.
    """
    rng = np.random.RandomState(seed)
    order = np.arange(len(examples))
    if shuffle:
        rng.shuffle(order)
    pools: dict[int, list] = {b: [] for b in bucket_sizes}
    for idx in order:
        x, y = examples[idx]
        bucket = pick_bucket(x.shape[0], bucket_sizes)
        pools[bucket].append((x, y))
        if len(pools[bucket]) == batch_size:
            yield make_batch(pools[bucket], bucket, max_label_len)
            pools[bucket] = []
    if not drop_remainder:
        for bucket, pool in pools.items():
            if pool:
                # pad the batch dim with repeats to keep static batch size;
                # real_rows marks the pads so they are never scored twice
                n_real = len(pool)
                while len(pool) < batch_size:
                    pool.append(pool[0])
                yield make_batch(pool, bucket, max_label_len, num_real=n_real)


class _PairView:
    """Lazy (features, labels) view over a dataset of example objects.

    bucketed_batches only ever indexes one element at a time, so this keeps
    streaming pipelines (cache_features=False) from materializing an epoch of
    features in RAM — each example is featurized when its index comes up.
    """

    def __init__(self, dataset):
        self._dataset = dataset

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, i):
        ex = self._dataset[i]
        return ex.features, ex.labels


def epoch_iterator(dataset, cfg, *, seed: int = 0, train: bool = True):
    """Adapter from SyntheticDataset/FeaturePipeline to bucketed batches."""
    if hasattr(dataset, "load"):  # TimitDataset: lazy audio -> features upstream
        raise NotImplementedError(
            "TIMIT batching needs the feature pipeline, which the port does not "
            "have yet (ROADMAP.md)"
        )
    return bucketed_batches(
        _PairView(dataset),
        batch_size=cfg.batch_size,
        bucket_sizes=cfg.bucket_sizes,
        max_label_len=cfg.max_label_len,
        shuffle=train,
        seed=seed,
        drop_remainder=train,
    )


class BatchStream:
    """Resumable epoch-shuffled batch stream.

    State is (epoch, index-within-epoch); `restore()` rebuilds the epoch's
    deterministic shuffle and fast-forwards, so a resumed run sees exactly the
    batches the interrupted run would have.
    """

    def __init__(self, dataset, data_cfg, *, seed: int = 0):
        self.dataset = dataset
        self.cfg = data_cfg
        self.seed = seed
        self.epoch = 0
        self.index = 0
        self._iter = None

    def state(self) -> dict:
        return {"epoch": self.epoch, "index": self.index}

    def restore(self, state: dict):
        self.epoch = int(state["epoch"])
        self.index = 0
        self._iter = self._make_epoch_iter()
        for _ in range(int(state["index"])):
            self._next_raw()

    def _make_epoch_iter(self):
        return epoch_iterator(
            self.dataset, self.cfg, seed=self.seed + self.epoch, train=True
        )

    def _next_raw(self):
        if self._iter is None:
            self._iter = self._make_epoch_iter()
        try:
            batch = next(self._iter)
            self.index += 1
            return batch
        except StopIteration:
            self.epoch += 1
            self.index = 0
            self._iter = self._make_epoch_iter()
            batch = next(self._iter)
            self.index = 1
            return batch

    def __iter__(self):
        return self

    def __next__(self):
        return self._next_raw()
