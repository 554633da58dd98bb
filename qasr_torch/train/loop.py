"""The training loop (counterpart of ``qasr/train/loop.py``), on one device
or on a world of ranks (one process a card, ``torch.distributed``): there
the (data, model) mesh comes from ``cfg.mesh`` (:func:`build_mesh_from_config`),
every rank draws the same global batches and trains its own rows through
the sharded step (``qasr_torch.parallel.train``), and only rank 0 writes
metrics and checkpoints.

A step loop over bucketed batches drawn by a prefetch thread: every
``log_every`` steps a metrics row (loss, grad norm, audio-seconds per second
per chip), every ``eval_every`` steps the greedy error rate over the eval set
(the corpus's dev split: TIMIT ``dev``, LibriSpeech ``dev-clean``; the train
set for ``synthetic`` or when the split is missing), and at eval and
``checkpoint_every`` steps a checkpoint (``qasr_torch.train.checkpoint``:
the step directory ``qasr_torch.infer.Transcriber`` reads as it is, the
batch stream's state, the best-dev-PER pointer). ``resume=True`` continues
from the latest checkpoint with the batches the interrupted run would have
drawn. Any model ``build_model`` builds trains here.
"""

from __future__ import annotations

import time
from functools import partial

import numpy as np
import torch

from qasr_torch.configs import Config
from qasr_torch.data.batching import BatchStream, Prefetcher, epoch_iterator
from qasr_torch.data.synthetic import SyntheticDataset
from qasr_torch.decode.scoring import batch_per
from qasr_torch.train.checkpoint import CheckpointManager
from qasr_torch.train.metrics import MetricWriter, device_memory_stats, state_bytes
from qasr_torch.train.state import TrainState, create_train_state
from qasr_torch.train.step import beam_eval_step, eval_step, train_step

FRAME_S = 0.010  # 10 ms hop: one frame is 10 ms of audio
# the split the loop evaluates on, where the corpus defines one
EVAL_SPLITS = {"timit": "dev", "librispeech": "dev-clean"}


def build_dataset(cfg: Config, *, seed: int = 0, split: str = "train",
                  device: torch.device | str = "cuda"):
    """The ``split`` of ``cfg``'s dataset: synthetic examples (one set,
    whatever the split), or a TIMIT or LibriSpeech split featurized on
    ``device`` (LibriSpeech's ``train`` is ``train-clean-100``). A missing
    corpus or split raises ``FileNotFoundError``."""
    d = cfg.data
    if d.dataset == "synthetic":
        return SyntheticDataset(
            vocab=cfg.model.vocab, n_mels=d.n_mels, num_examples=d.num_synthetic, seed=seed
        )
    if d.dataset == "timit":
        from qasr_torch.data.pipeline import TimitFeaturePipeline

        return TimitFeaturePipeline(cfg, split=split, device=device)
    if d.dataset == "librispeech":
        from qasr_torch.data.pipeline import LibriFeaturePipeline

        return LibriFeaturePipeline(
            cfg, split=split if split != "train" else "train-clean-100", device=device
        )
    raise ValueError(f"unsupported dataset {d.dataset!r}")


def build_eval_dataset(cfg: Config, train_dataset=None, *,
                       device: torch.device | str = "cuda"):
    """The set model selection runs on: the corpus's dev split
    (``EVAL_SPLITS``), or the train set (``train_dataset``, built when not
    given) for ``synthetic`` and when that split is missing."""
    split = EVAL_SPLITS.get(cfg.data.dataset)
    if split is not None:
        try:
            return build_dataset(cfg, split=split, device=device)
        except FileNotFoundError:
            pass
    if train_dataset is None:
        train_dataset = build_dataset(cfg, seed=cfg.train.seed, device=device)
    return train_dataset


def _check_labels(batch, vocab: int) -> None:
    """A label id >= vocab silently corrupts the CTC lattice; fail at the
    source instead."""
    mx = int(np.max(batch["labels"], initial=0))
    if mx >= vocab:
        raise ValueError(
            f"label id {mx} out of range for model.vocab={vocab}; the corpus "
            "symbol inventory and the model vocabulary disagree"
        )


def build_mesh_from_config(cfg: Config):
    """The (data, model) mesh of ``cfg.mesh`` over this world's ranks, by the
    reference's rules (:func:`mesh_shape`)."""
    from qasr_torch.parallel.mesh import make_mesh, world

    n_data, n_model, used = mesh_shape(cfg, world()[1])
    return make_mesh(n_data, n_model, ranks=list(range(used)))


def mesh_shape(cfg: Config, n: int) -> tuple[int, int, int]:
    """(n_data, n_model, ranks used) of ``cfg.mesh`` on ``n`` ranks, as
    ``qasr/train/loop.py:build_mesh_from_config``: the model axis clamped
    down to the largest divisor of ``n``; ``data_axis == -1`` takes every
    remaining rank, an explicit one exactly ``data_axis * n_model`` of them
    (fewer than the world is allowed, more raises)."""
    m = cfg.mesh
    n_model = min(m.model_axis, n)
    while n % n_model:
        n_model -= 1
    if m.data_axis == -1:
        return n // n_model, n_model, n
    want = m.data_axis * n_model
    if want > n:
        raise ValueError(f"mesh {m.data_axis}x{n_model} needs {want} devices, have {n}")
    return m.data_axis, n_model, want


def evaluate(cfg: Config, model: torch.nn.Module, dataset, *, beam: bool = False,
             mesh=None) -> dict:
    """Error rate (``per``) and per-token loss over one pass of ``dataset``,
    decoded greedily (the dev protocol) or with the prefix beam on the
    device (``beam=True``, the final numbers: one forward a batch for the
    loss and the beam, ``beam_eval_step``): the PER on the 39-phone fold for
    TIMIT, the raw symbol error rate otherwise (for LibriSpeech characters,
    the CER). Each batch's loss is weighted by its real label tokens;
    remainder pad rows are scored once, never twice.

    On a ``mesh`` (every rank of the world calls this) each rank decodes its
    rows of each batch (``qasr_torch.parallel.train``'s sharded steps) and
    scores them against its rows of the references (``host_rows``), pad
    rows dropped; the ranks of model index 0 count, and the counters are
    summed over the world (``aggregate_per``): each utterance exactly once,
    an uneven last batch included."""
    counts = True
    if mesh is None:
        step = partial(beam_eval_step if beam else eval_step, cfg, model)
    else:
        from qasr_torch.parallel import (
            aggregate_per,
            host_rows,
            make_sharded_beam_decode_step,
            make_sharded_eval_step,
        )
        from qasr_torch.parallel.mesh import MODEL_AXIS

        step = partial((make_sharded_beam_decode_step if beam else make_sharded_eval_step)(
            cfg, mesh), model)
        counts = mesh.shape[MODEL_AXIS] == 1 or mesh.index(MODEL_AXIS) == 0
    errs = total = 0
    losses = []
    for batch in epoch_iterator(dataset, cfg.data, train=False):
        _check_labels(batch, cfg.model.vocab)
        out = step(batch)
        real = np.asarray(batch["real_rows"])
        losses.append((float(out["loss"]), int(np.sum(batch["label_lengths"] * real))))
        refs = {k: np.asarray(batch[k]) for k in ("labels", "label_lengths", "real_rows")}
        if mesh is not None:
            refs = host_rows(refs, mesh)
        keep = refs["real_rows"]
        if not counts or not keep.any():
            continue
        e, n = batch_per(
            refs["labels"][keep],
            refs["label_lengths"][keep],
            out["decoded"].cpu().numpy()[keep],
            out["decoded_lengths"].cpu().numpy()[keep],
            fold=cfg.data.dataset == "timit",
        )
        errs += e
        total += n
    if mesh is not None:
        errs, total = aggregate_per(errs, total)
    wsum = sum(w for _, w in losses)
    return {
        "loss": sum(v * w for v, w in losses) / wsum if wsum else float("nan"),
        "per": errs / max(total, 1),
    }


def train(
    cfg: Config,
    *,
    device: torch.device | str = "cuda",
    checkpoint_dir: str | None = None,
    metrics_dir: str | None = None,
    resume: bool = False,
) -> tuple[TrainState, dict]:
    """Train ``cfg`` to ``cfg.train.num_steps`` on one device (the GPU unless
    the caller asks for the CPU). Checkpoints go to
    ``<checkpoint_dir>/step_<n>`` (default ``cfg.train.checkpoint_dir``) and
    metric rows to ``<metrics_dir>/metrics.jsonl`` (default the checkpoint
    directory). ``resume=True`` continues from the latest checkpoint there,
    when there is one. Under ``cfg.train.debug_nans`` every op is checked
    for non-finite values (``qasr_torch.utils.debug.nan_debug``). Returns the
    state and the last logged metrics (with the last eval's
    ``dev_loss``/``dev_per`` and ``checkpoint``)."""
    kw = dict(device=device, checkpoint_dir=checkpoint_dir, metrics_dir=metrics_dir,
              resume=resume)
    if cfg.train.debug_nans:
        from qasr_torch.utils.debug import nan_debug

        with nan_debug():
            return _train(cfg, **kw)
    return _train(cfg, **kw)


def _build_datasets(cfg: Config, device, rank: int, size: int):
    """The train and eval sets; in a world, rank 0 builds (and caches) them
    first and the other ranks then read its cache."""
    import torch.distributed as dist

    if size > 1 and rank > 0:
        dist.barrier()
    dataset = build_dataset(cfg, seed=cfg.train.seed, device=device)
    eval_dataset = build_eval_dataset(cfg, dataset, device=device)
    if size > 1 and rank == 0:
        dist.barrier()
    return dataset, eval_dataset


def _bytes_row(persistent: dict, gathered: dict, device, rank: int, size: int) -> dict:
    """The metrics row of the state's bytes on the devices: the largest and
    smallest rank's persistent state, the gathered kernels' bytes, and the
    allocator's bytes in use; {} off the card."""
    from qasr_torch.parallel.collectives import allsum_across_hosts

    mem = device_memory_stats(device)
    mine = np.zeros((3, size), np.int64)
    mine[:, rank] = (sum(persistent.values()), sum(gathered.values()),
                     sum(v["bytes_in_use"] for v in mem.values()))
    per_rank = allsum_across_hosts(mine)
    if not persistent:
        return {}
    row = {"state_bytes_per_device_max": int(per_rank[0].max()),
           "state_bytes_per_device_min": int(per_rank[0].min())}
    if gathered:
        row["gathered_weight_bytes_per_device_max"] = int(per_rank[1].max())
    if mem:
        row["hbm_bytes_in_use_max"] = int(per_rank[2].max())
    return row


def _train(cfg: Config, *, device, checkpoint_dir, metrics_dir, resume):
    import torch.distributed as dist

    from qasr_torch.parallel.mesh import world

    device = torch.device(device)
    rank, size = world()
    ckpt_dir = checkpoint_dir or cfg.train.checkpoint_dir
    dataset, eval_dataset = _build_datasets(cfg, device, rank, size)
    stream = BatchStream(dataset, cfg.data, seed=cfg.train.seed)
    first = next(stream)
    _check_labels(first, cfg.model.vocab)
    mesh = None
    step_fn = train_step
    if dist.is_initialized():
        from qasr_torch.parallel import (
            create_sharded_train_state,
            make_sharded_train_step,
        )

        mesh = build_mesh_from_config(cfg)
        if mesh.coords is None:
            raise ValueError(f"rank {rank} is outside the {mesh.shape} mesh of cfg.mesh; "
                             f"launch {mesh.size} ranks")
        state, _ = create_sharded_train_state(cfg, mesh, device=device)
        step_fn = make_sharded_train_step(cfg, mesh)
    else:
        state = create_train_state(cfg, device=device)
    ckpt = CheckpointManager(cfg, directory=ckpt_dir)
    if resume and ckpt.latest_step() is not None:
        # the reference's order: `first` is drawn above, then the stream is
        # restored and `first` drawn again from where the saved step left it
        latest = ckpt.latest_step()
        data_state = ckpt.restore_data_state(latest)
        if data_state is not None:
            stream.restore(data_state)
            first = next(stream)
            _check_labels(first, cfg.model.vocab)
        ckpt.restore(latest, state)
        if rank == 0:
            print(f"[qasr] resumed from step {state.step}", flush=True)

    writer = MetricWriter((metrics_dir or ckpt_dir) if rank == 0 else None, console=rank == 0)
    # one-time accounting of the state's bytes on each device (and the
    # allocator's), as the reference writes it: a rank's persistent state
    # (its shards and moments), and beside it the kernels it gathers
    persistent, gathered = state_bytes(state)
    row = _bytes_row(persistent, gathered, device, rank, size)
    if row:
        writer.write(state.step, row)

    is_cuda = device.type == "cuda"
    last: dict = {}
    # the state of the batch `first` is, taken before the producer thread
    # starts drawing from the stream
    batch, batch_state = first, stream.state()
    prefetch = Prefetcher(stream, depth=cfg.data.prefetch_depth)
    t_window, frames_window = time.perf_counter(), 0
    try:
        for step in range(state.step, cfg.train.num_steps):
            m = step_fn(state, batch)
            frames_window += int(np.sum(batch["feature_lengths"]))
            if (step + 1) % cfg.train.log_every == 0:
                if is_cuda:
                    torch.cuda.synchronize(device)
                now = time.perf_counter()
                last = {
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "audio_s_per_s_per_chip": frames_window * FRAME_S
                    / max(now - t_window, 1e-9) / size,
                }
                writer.write(step + 1, last)
                t_window, frames_window = now, 0
            if (step + 1) % cfg.train.eval_every == 0:
                dev = evaluate(cfg, state.model, eval_dataset, mesh=mesh)
                writer.write(step + 1, {f"dev_{k}": v for k, v in dev.items()})
                last.update({f"dev_{k}": v for k, v in dev.items()})
                last["checkpoint"] = ckpt.save(step + 1, state, dev_per=dev["per"],
                                               data_state=batch_state)
            elif (step + 1) % cfg.train.checkpoint_every == 0:
                last["checkpoint"] = ckpt.save(step + 1, state, data_state=batch_state)
            if step + 1 < cfg.train.num_steps:
                batch, batch_state = next(prefetch)
                _check_labels(batch, cfg.model.vocab)
    finally:
        prefetch.close()
        writer.close()
    return state, last
