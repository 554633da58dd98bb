"""Bucketed padding + batching for CTC training, the resumable batch stream
and its prefetch thread (the port's own copy of ``qasr/data/batching.py``;
tests hold the batches equal to the reference's).

Utterances are bucketed to a small set of frame ceilings, and every batch
has static shapes ``[B, T_bucket, F, 4]`` / ``[B, L_max]``. Batches are numpy
dicts; the train step moves them to the device.
"""

from __future__ import annotations

import queue
import threading
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
    # streaming pipelines featurize a whole upcoming block in one device
    # dispatch when told the epoch order ahead of consumption (see
    # FeaturePipeline.prefetch); everything else ignores the hint
    prefetch = getattr(examples, "prefetch", None)
    block = max(batch_size, 16)
    pools: dict[int, list] = {b: [] for b in bucket_sizes}
    for pos, idx in enumerate(order):
        if prefetch is not None and pos % block == 0:
            prefetch(order[pos : pos + block])
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

    def prefetch(self, indices):
        p = getattr(self._dataset, "prefetch", None)
        if p is not None:
            p(indices)


def epoch_iterator(dataset, cfg, *, seed: int = 0, train: bool = True):
    """Adapter from SyntheticDataset/FeaturePipeline to bucketed batches."""
    if hasattr(dataset, "load"):  # TimitDataset: lazy audio -> features upstream
        raise NotImplementedError(
            "TIMIT batching goes through qasr_torch.data.pipeline (features on device)"
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


class _PrefetchError:
    """Sentinel carrying a producer-thread exception to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class Prefetcher:
    """Background-thread batch prefetch (bounded queue).

    Overlaps host-side batch preparation (and, for a streaming pipeline, the
    featurization on the card) with the train step. Yields ``(batch,
    stream_state)`` pairs where ``stream_state`` is the BatchStream state
    *after* producing that batch, so checkpoint/resume stays exact under
    prefetch (the state saved with a step is the state of the batch actually
    trained on). An exception in the producer re-raises in the consumer, on
    this and every later ``next``.
    """

    def __init__(self, stream: "BatchStream", *, depth: int = 2):
        self._stream = stream
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._failed: _PrefetchError | None = None
        self._thread = threading.Thread(target=self._fill, name="qasr-prefetch", daemon=True)
        self._thread.start()

    def _fill(self):
        while not self._stop.is_set():
            try:
                item = (next(self._stream), self._stream.state())
            except BaseException as e:  # propagate instead of hanging __next__
                item = _PrefetchError(e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item, _PrefetchError):
                return

    def __iter__(self):
        return self

    def __next__(self):
        # after a producer failure the thread has exited, so the queue would
        # never fill again: keep the error sticky instead of blocking forever
        if self._failed is None:
            item = self._q.get()
            if not isinstance(item, _PrefetchError):
                return item
            self._failed = item
        raise RuntimeError("prefetch thread failed") from self._failed.error

    def close(self):
        """Stop the producer and wait for it (it ends within its put timeout
        or when the batch it is making is done)."""
        self._stop.set()
        self._thread.join()


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
            try:
                batch = next(self._iter)
            except StopIteration:
                raise ValueError(
                    f"an epoch of {len(self.dataset)} examples fills no batch of "
                    f"{self.cfg.batch_size} in any bucket of {self.cfg.bucket_sizes}: lower "
                    "data.batch_size"
                ) from None
            self.index = 1
            return batch

    def __iter__(self):
        return self

    def __next__(self):
        return self._next_raw()
