"""Train state: model, optimizer, learning-rate schedule, dropout generator
(counterpart of ``qasr/train/state.py:157-182``).

The optimizer is optax's ``chain(clip_by_global_norm, adamw)`` of the JAX
package, rebuilt in PyTorch:

- clipping as optax does it: gradients scale by ``max / norm`` only when
  ``norm >= max`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm,
  which is not optax's rule), done in
  :func:`qasr_torch.train.step.apply_gradients`;
- AdamW with b1 0.9, b2 0.999, eps 1e-8 and the config's weight decay
  (``torch.optim.AdamW`` computes the same update as ``optax.adamw``);
- the learning rate of optax's ``warmup_cosine_decay_schedule``, evaluated
  at the count BEFORE the update: the first update uses ``lr(0) = 0``, so
  step 0 leaves the params unchanged, as in JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from qasr_torch.configs import Config
from qasr_torch.models import build_model


def warmup_cosine_schedule(cfg: Config) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(num_steps,
    warmup + 1), 0.05 * lr), as ``qasr/train/state.py:159`` builds it."""
    t = cfg.train
    peak, warmup = t.learning_rate, t.warmup_steps
    decay = max(t.num_steps, t.warmup_steps + 1) - warmup
    alpha = 0.0 if peak == 0.0 else (peak * 0.05) / peak

    def lr(step: int) -> float:
        if step < warmup:
            return peak * step / warmup  # linear from init_value 0
        count = min(step - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return lr


def build_optimizer(cfg: Config, params) -> torch.optim.AdamW:
    """AdamW over ``params``; its learning rate is set before every step from
    :func:`warmup_cosine_schedule`."""
    return torch.optim.AdamW(
        params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.train.weight_decay
    )


@dataclass
class TrainState:
    """What a train step reads and advances: the step count (the optimizer
    updates taken), the model (any encoder of ``build_model``: f32 master
    params), its optimizer, and the generator the dropout masks come from."""

    cfg: Config
    model: nn.Module
    optimizer: torch.optim.AdamW
    generator: torch.Generator
    schedule: Callable[[int], float]
    step: int = 0

    def full_optimizer_state(self) -> dict:
        """The optimizer's state_dict in the one-device layout, as a
        checkpoint holds it."""
        return self.optimizer.state_dict()

    def load_full(self, params, optimizer_state: dict) -> None:
        """Load whole weights (a state_dict) and a one-device optimizer
        state_dict."""
        self.model.load_state_dict(params)
        self.optimizer.load_state_dict(optimizer_state)


def create_train_state(
    cfg: Config,
    *,
    device: torch.device | str = "cuda",
    params=None,
) -> TrainState:
    """A train-mode model for ``cfg`` on ``device`` (the GPU unless the caller
    asks for the CPU), its weights drawn from ``cfg.train.seed`` or loaded
    from ``params`` (a state_dict); AdamW; a dropout generator on the device
    seeded from ``cfg.train.seed + 1``."""
    device = torch.device(device)
    model = build_model(
        cfg, generator=torch.Generator().manual_seed(cfg.train.seed), device=device, train=True
    )
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    return TrainState(
        cfg=cfg,
        model=model,
        optimizer=build_optimizer(cfg, model.parameters()),
        generator=torch.Generator(device=device).manual_seed(cfg.train.seed + 1),
        schedule=warmup_cosine_schedule(cfg),
    )
