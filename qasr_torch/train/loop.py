"""The training loop on one device (counterpart of ``qasr/train/loop.py:86-198``
without its mesh, prefetch thread and resume).

A step loop over bucketed batches: every ``log_every`` steps a metrics line
(loss, grad norm, audio-seconds per second), every ``eval_every`` steps the
greedy error rate over the eval set, and at eval and ``checkpoint_every``
steps a checkpoint directory that ``qasr_torch.infer.Transcriber`` reads as
it is. Any model ``build_model`` builds trains here (the QCNN and the
QCNN-LSTM); only the ``synthetic`` dataset is ported.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from qasr_torch.bridge import save_params_npz
from qasr_torch.configs import Config
from qasr_torch.data.batching import BatchStream, epoch_iterator
from qasr_torch.data.synthetic import SyntheticDataset
from qasr_torch.decode.scoring import batch_per
from qasr_torch.train.state import TrainState, create_train_state
from qasr_torch.train.step import eval_step, train_step

FRAME_S = 0.010  # 10 ms hop: one frame is 10 ms of audio


def build_dataset(cfg: Config, *, seed: int = 0):
    """The training dataset of ``cfg``. Only ``synthetic`` is ported: TIMIT and
    LibriSpeech need the feature pipeline (ROADMAP.md)."""
    d = cfg.data
    if d.dataset == "synthetic":
        return SyntheticDataset(
            vocab=cfg.model.vocab, n_mels=d.n_mels, num_examples=d.num_synthetic, seed=seed
        )
    raise NotImplementedError(
        f"dataset {d.dataset!r} is not ported yet: it needs the feature pipeline "
        "(ROADMAP.md, Queue 1 item 8)"
    )


def _check_labels(batch, vocab: int) -> None:
    """A label id >= vocab silently corrupts the CTC lattice; fail at the
    source instead."""
    mx = int(np.max(batch["labels"], initial=0))
    if mx >= vocab:
        raise ValueError(
            f"label id {mx} out of range for model.vocab={vocab}; the corpus "
            "symbol inventory and the model vocabulary disagree"
        )


def save_checkpoint(state: TrainState, directory: str) -> str:
    """Write ``params.npz`` (f32, JAX parameter names), ``config.json`` and
    ``train_state.pt`` (step, optimizer and dropout-generator state, with
    ``torch.save``) into ``directory``; returns it."""
    os.makedirs(directory, exist_ok=True)
    save_params_npz(state.model.state_dict(), os.path.join(directory, "params.npz"))
    with open(os.path.join(directory, "config.json"), "w") as f:
        f.write(state.cfg.to_json())
    torch.save(
        {"step": state.step, "optimizer": state.optimizer.state_dict(),
         "generator": state.generator.get_state()},
        os.path.join(directory, "train_state.pt"),
    )
    return directory


def evaluate(cfg: Config, model: torch.nn.Module, dataset) -> dict:
    """Greedy error rate (``per``) and per-token loss over one pass of
    ``dataset``: the PER on the 39-phone fold for TIMIT, the raw symbol
    error rate otherwise (for LibriSpeech characters, the CER). Remainder
    pad rows are scored once, never twice."""
    errs = total = 0
    losses = []
    for batch in epoch_iterator(dataset, cfg.data, train=False):
        _check_labels(batch, cfg.model.vocab)
        out = eval_step(cfg, model, batch)
        real = np.asarray(batch["real_rows"])
        losses.append((float(out["loss"]), int(np.sum(batch["label_lengths"] * real))))
        e, n = batch_per(
            np.asarray(batch["labels"])[real],
            np.asarray(batch["label_lengths"])[real],
            out["decoded"].cpu().numpy()[real],
            out["decoded_lengths"].cpu().numpy()[real],
            fold=cfg.data.dataset == "timit",
        )
        errs += e
        total += n
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
) -> tuple[TrainState, dict]:
    """Train ``cfg`` to ``cfg.train.num_steps`` on one device (the GPU unless
    the caller asks for the CPU). Checkpoints go to
    ``<checkpoint_dir>/step_<n>`` (default ``cfg.train.checkpoint_dir``) and
    metric lines to ``<checkpoint_dir>/metrics.jsonl``. Returns the state and
    the last logged metrics (with the last eval's ``dev_loss``/``dev_per``
    and ``checkpoint``)."""
    ckpt_dir = checkpoint_dir or cfg.train.checkpoint_dir
    os.makedirs(ckpt_dir, exist_ok=True)
    dataset = build_dataset(cfg, seed=cfg.train.seed)
    stream = BatchStream(dataset, cfg.data, seed=cfg.train.seed)
    state = create_train_state(cfg, device=device)
    is_cuda = torch.device(device).type == "cuda"
    last: dict = {}
    t_window, frames_window = time.perf_counter(), 0
    with open(os.path.join(ckpt_dir, "metrics.jsonl"), "a") as log:

        def write(step: int, row: dict) -> None:
            log.write(json.dumps({"step": step, **row}) + "\n")
            log.flush()

        for step in range(cfg.train.num_steps):
            batch = next(stream)
            _check_labels(batch, cfg.model.vocab)
            m = train_step(state, batch)
            frames_window += int(np.sum(batch["feature_lengths"]))
            if (step + 1) % cfg.train.log_every == 0:
                if is_cuda:
                    torch.cuda.synchronize(device)
                now = time.perf_counter()
                last = {
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "audio_s_per_s": frames_window * FRAME_S / max(now - t_window, 1e-9),
                }
                write(step + 1, last)
                t_window, frames_window = now, 0
            do_eval = (step + 1) % cfg.train.eval_every == 0
            if do_eval:
                dev = evaluate(cfg, state.model, dataset)
                write(step + 1, {f"dev_{k}": v for k, v in dev.items()})
                last.update({f"dev_{k}": v for k, v in dev.items()})
            if do_eval or (step + 1) % cfg.train.checkpoint_every == 0:
                path = save_checkpoint(state, os.path.join(ckpt_dir, f"step_{step + 1}"))
                last["checkpoint"] = path
    return state, last
