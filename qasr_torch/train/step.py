"""Train and eval steps: forward, CTC loss, backward, clipped AdamW update;
the greedy and the beam eval steps (counterpart of ``qasr/train/step.py``).

PyTorch runs eagerly, so a step is a sequence of kernel launches on the
current stream; nothing here synchronises with the device except reading a
metric back.
"""

from __future__ import annotations

import torch

from qasr_torch.configs import Config
from qasr_torch.decode.beam import ctc_beam_search_decode
from qasr_torch.ops.ctc import ctc_greedy_decode, ctc_loss
from qasr_torch.train.state import TrainState


_BATCH_DTYPES = {
    "features": torch.float32,
    "feature_lengths": torch.int64,
    "labels": torch.int64,
    "label_lengths": torch.int64,
    "real_rows": torch.bool,
}


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays (``qasr_torch.data.batching.make_batch``) or
    tensors, as tensors on ``device``: f32 features, int64 lengths and
    labels, bool ``real_rows`` (when present)."""
    return {
        k: torch.as_tensor(v).to(device, dtype, non_blocking=True)
        for k, dtype in _BATCH_DTYPES.items()
        if (v := batch.get(k)) is not None
    }


def loss_fn(cfg: Config, logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """CTC loss normalised per label token, as ``make_loss_fn``:
    ``sum(losses * real) / max(sum(label_lengths * real), 1)``; rows with
    ``real_rows`` False (remainder-batch pads) count in neither."""
    losses = ctc_loss(
        logits, batch["labels"], batch["feature_lengths"], batch["label_lengths"],
        blank_id=cfg.decode.blank_id,
    )
    label_lens = batch["label_lengths"]
    mask = batch.get("real_rows")
    if mask is not None:
        losses = losses * mask
        label_lens = label_lens * mask
    return losses.sum() / label_lens.sum().clamp_min(1)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def apply_gradients(state: TrainState) -> torch.Tensor:
    """optax's ``chain(clip_by_global_norm, adamw)`` on the gradients held in
    the params' ``.grad``, at the learning rate of the step count before the
    update; advances ``state.step``. Returns the global norm before clipping."""
    grads = [p.grad for p in state.model.parameters()]
    gnorm = global_norm(grads)
    clip = state.cfg.train.grad_clip
    # in place of the gradients: scale by max/norm only when norm >= max
    scale = torch.where(gnorm < clip, torch.ones_like(gnorm), clip / gnorm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return gnorm


def train_step(state: TrainState, batch: dict, *, plain: bool = False) -> dict:
    """One update of ``state`` on ``batch`` (numpy or device tensors).

    Returns device scalars: ``loss``, ``grad_norm`` (before clipping) and
    ``frames``. ``plain=True`` runs every kernel's plain version (the card's
    reference path).
    """
    model = state.model
    device = next(model.parameters()).device
    batch = batch_to_device(batch, device)
    model.train()
    logits = model(batch["features"], lengths=batch["feature_lengths"], plain=plain,
                   generator=state.generator)
    loss = loss_fn(state.cfg, logits, batch)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    gnorm = apply_gradients(state)
    return {
        "loss": loss.detach(),
        "grad_norm": gnorm.detach(),
        "frames": batch["feature_lengths"].sum(),
    }


def _eval_forward(model: torch.nn.Module, batch: dict) -> tuple[torch.Tensor, dict]:
    """Eval-mode logits of ``batch`` (moved to the model's device), and the
    batch as device tensors."""
    device = next(model.parameters()).device
    batch = batch_to_device(batch, device)
    was_training = model.training
    model.eval()
    try:
        logits = model(batch["features"], lengths=batch["feature_lengths"])
    finally:
        model.train(was_training)
    return logits, batch


@torch.no_grad()
def eval_step(cfg: Config, model: torch.nn.Module, batch: dict) -> dict:
    """Eval-mode loss and greedy decode of ``batch``: ``loss`` (device
    scalar), ``decoded [B, T]`` padded with -1 and ``decoded_lengths [B]``."""
    logits, batch = _eval_forward(model, batch)
    decoded, lengths = ctc_greedy_decode(
        logits, batch["feature_lengths"], blank_id=cfg.decode.blank_id
    )
    return {"loss": loss_fn(cfg, logits, batch), "decoded": decoded, "decoded_lengths": lengths}


@torch.no_grad()
def beam_eval_step(cfg: Config, model: torch.nn.Module, batch: dict) -> dict:
    """The final-numbers eval step: one eval-mode forward, then the loss and
    the prefix beam decode on the device (``cfg.decode``'s width, blank and
    pruning, ``max_len = cfg.data.max_label_len``), as
    ``make_beam_eval_step``. Returns ``loss``, ``decoded [B, max_len]``
    padded with -1, ``decoded_lengths [B]`` and ``log_score [B]``."""
    logits, batch = _eval_forward(model, batch)
    seq, lens, score = ctc_beam_search_decode(
        logits,
        batch["feature_lengths"],
        beam_width=cfg.decode.beam_width,
        blank_id=cfg.decode.blank_id,
        max_len=int(cfg.data.max_label_len),
        prune_logp=cfg.decode.beam_prune_logp,
    )
    return {"loss": loss_fn(cfg, logits, batch), "decoded": seq, "decoded_lengths": lens,
            "log_score": score}
