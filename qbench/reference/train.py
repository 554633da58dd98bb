"""The reference training step: the model's forward, the CTC loss per label
token, the gradients, clipping by the global norm and AdamW at the warmup-
cosine learning rate, in plain float32.

The optimizer is the one the configurations state: the gradients scale by
``clip / norm`` when their global norm reaches ``clip``; AdamW with b1 0.9,
b2 0.999, eps 1e-8 (outside the square root), bias-corrected moments and
decoupled weight decay; the learning rate at the update count before the
update, linear from 0 over the warmup, then a cosine down to 5% of the peak
at ``num_steps``.
"""

from __future__ import annotations

import math

import torch

from qbench.reference.ctc import ctc_nll
from qbench.reference.model import Masks, forward

B1, B2, EPS = 0.9, 0.999, 1e-8


def learning_rate(train: dict, step: int) -> float:
    peak, warmup = train["learning_rate"], train["warmup_steps"]
    if step < warmup:
        return peak * step / warmup
    decay = max(train["num_steps"], warmup + 1) - warmup
    frac = min(step - warmup, decay) / decay
    floor = 0.05 * peak
    return floor + (peak - floor) * 0.5 * (1.0 + math.cos(math.pi * frac))


def loss_and_grads(params: dict, model: dict, batch: dict, generator: torch.Generator,
                   device, prec: str = "f32", rows_per_block: int | None = None,
                   remat: bool = False):
    """The train-mode loss of ``batch`` (numpy or tensors), its gradients
    ``{name: tensor}`` and its logits, computed in blocks of rows (the
    dropout masks drawn whole first, in the order the forward meets the
    layers)."""
    feats = torch.as_tensor(batch["features"]).to(device, torch.float32)
    lens = torch.as_tensor(batch["feature_lengths"]).to(device, torch.long)
    labels = torch.as_tensor(batch["labels"]).to(device, torch.long)
    llens = torch.as_tensor(batch["label_lengths"]).to(device, torch.long)
    b, t = feats.shape[:2]
    masks = Masks(model, b, t, generator, device)
    tokens = max(int(llens.sum()), 1)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    step = rows_per_block or b
    total, out = 0.0, []
    for lo in range(0, b, step):
        hi = min(b, lo + step)
        logits = forward(leaves, model, feats[lo:hi], lens[lo:hi], masks=masks.rows(lo, hi),
                         keep=masks.keep, prec=prec, remat=remat)
        nll = ctc_nll(logits, labels[lo:hi], lens[lo:hi], llens[lo:hi])
        loss = nll.sum() / tokens
        loss.backward()
        total += float(loss.detach())
        out.append(logits.detach())
        del logits, nll, loss
    return total, {k: v.grad.detach() for k, v in leaves.items()}, torch.cat(out)


def global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


class AdamW:
    """AdamW state over a dict of f32 parameters."""

    def __init__(self, params: dict, weight_decay: float):
        self.wd = weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def update(self, params: dict, grads: dict, lr: float) -> dict:
        self.t += 1
        bc1, bc2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = B1 * self.m[k] + (1 - B1) * g
            self.v[k] = B2 * self.v[k] + (1 - B2) * g * g
            p = p * (1 - lr * self.wd)
            out[k] = p - (lr / bc1) * self.m[k] / (self.v[k].sqrt() / math.sqrt(bc2) + EPS)
        return out


def train_steps(params: dict, model: dict, train: dict, batches: list, generator,
                device, prec: str = "f32", rows_per_block: int | None = None,
                remat: bool = False) -> dict:
    """Run ``len(batches)`` updates from ``params``. Returns the losses, the
    first step's logits and clipped gradients (as the optimizer takes them)
    and each parameter's change over all the steps."""
    opt = AdamW(params, train["weight_decay"])
    p = {k: v.detach().clone() for k, v in params.items()}
    losses, first, logits0 = [], None, None
    for i, batch in enumerate(batches):
        loss, grads, logits = loss_and_grads(p, model, batch, generator, device, prec,
                                             rows_per_block, remat)
        norm = global_norm(grads)
        clip = train["grad_clip"]
        scale = 1.0 if float(norm) < clip else clip / float(norm)
        grads = {k: g * scale for k, g in grads.items()}
        if i == 0:
            first, logits0 = grads, logits
        with torch.no_grad():
            p = opt.update(p, grads, learning_rate(train, i))
        losses.append(loss)
    change = {k: (p[k] - params[k]) for k in params}
    return {"losses": losses, "first_grads": first, "change": change, "logits": logits0}
