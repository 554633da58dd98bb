"""Sharded training, eval and beam steps: DP over "data", weight-sharded TP
over "model" (counterpart of ``qasr/parallel/train.py``).

One process a device. Every process holds the whole global batch (each
draws the same batches from the same seeded stream) and runs its data
index's rows; ranks that share a data index share the rows. A train step:

1. forward and backward on the rank's rows through the model's whole
   weights (kernels A, B and C on the card, as a one-device step), the
   loss of those rows over the GLOBAL batch's real label tokens, so that
   the ranks' losses sum to the global per-token loss;
2. the gradients summed over the data group (``all_reduce``), then cut to
   the rank's shards;
3. the global norm of the whole model's gradient: the sharded leaves' sums
   of squares summed over the model group, each replicated leaf counted
   once; optax's clip and the AdamW update of the rank's shards and
   moments (``qasr_torch.train.step.clip_and_update``);
4. the updated shards gathered over the model group into the whole
   weights (``all_gather``): the reference's weight-sharded storage with
   gathered compute.

In a world of one rank every collective is skipped and the step is
``qasr_torch.train.step.train_step``'s arithmetic, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from qasr_torch.configs import Config
from qasr_torch.parallel.collectives import all_gather_cat, gather_list
from qasr_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, world
from qasr_torch.parallel.sharding import shard_batch, shard_leaf, shard_rows, tree_shardings
from qasr_torch.train.state import TrainState, build_optimizer, create_train_state
from qasr_torch.train.step import (
    batch_to_device,
    beam_eval_step,
    clip_and_update,
    eval_step,
    forward_backward,
)
from qasr_torch.utils.profiling import span


def host_rows(tree, mesh: Mesh | None = None):
    """This rank's contiguous rows of a batch every process holds whole
    (a mapping of arrays or tensors): by its data index on ``mesh``, or by
    its rank in the world without one (``shard_batch``). The identity for
    one rank. Callers scoring a sharded step's outputs slice the references
    with it."""
    n = world()[1] if mesh is None else mesh.shape[DATA_AXIS]
    return tree if n == 1 else shard_batch(mesh, tree)


def _global_tokens(batch: dict, device) -> torch.Tensor:
    """The global batch's real label tokens, int64 on ``device``."""
    lens = np.asarray(batch["label_lengths"]).astype(np.int64)
    real = batch.get("real_rows")
    if real is not None:
        lens = lens * np.asarray(real)
    return torch.tensor(int(lens.sum()), dtype=torch.int64, device=device)


@dataclass(eq=False)
class ShardedTrainState(TrainState):
    """A train state whose optimizer updates this rank's shards.

    ``model`` holds the whole weights the forward and backward run on;
    ``shards[name]`` is what the optimizer updates for that parameter: the
    rank's Cout slice of a kernel sharded over "model" (a tensor of its
    own), else the model's parameter itself. ``specs`` are the leaves'
    shardings (``qasr_torch.parallel.sharding``)."""

    mesh: Mesh | None = None
    specs: dict = field(default_factory=dict)
    shards: dict = field(default_factory=dict)

    def sharded(self) -> list[str]:
        """The leaves whose shard is a slice (under a model axis > 1)."""
        params = dict(self.model.named_parameters())
        return [k for k, v in self.shards.items() if v is not params[k]]

    @torch.no_grad()
    def gather_params(self) -> None:
        """The shards gathered over the model group into the model's whole
        weights: one ``all_gather`` of every sharded leaf, flattened."""
        names = self.sharded()
        if not names:
            return
        flat = torch.cat([self.shards[k].reshape(-1) for k in names])
        parts = gather_list(flat, self.mesh.group(MODEL_AXIS))
        params = dict(self.model.named_parameters())
        off = 0
        for k in names:
            shard = self.shards[k]
            pieces = [p[off:off + shard.numel()].view_as(shard) for p in parts]
            params[k].copy_(torch.cat(pieces, dim=-1))
            off += shard.numel()

    def full_optimizer_state(self) -> dict:
        """The optimizer's state_dict with every sharded moment gathered
        over the model group: the one-device layout (collective: every rank
        of the world calls it)."""
        sd = self.optimizer.state_dict()
        # state_dict() shares each slot with the live state: copy before editing
        sd["state"] = {i: dict(slot) for i, slot in sd["state"].items()}
        names = list(self.shards)
        for k in self.sharded():
            slot = sd["state"].get(names.index(k))
            if slot is None:  # no update taken yet
                continue
            for key in ("exp_avg", "exp_avg_sq"):
                slot[key] = all_gather_cat(slot[key], self.mesh.group(MODEL_AXIS))
        return sd

    @torch.no_grad()
    def load_full(self, params, optimizer_state: dict) -> None:
        """Load whole weights and a one-device optimizer state_dict, each
        rank keeping its shards of the sharded leaves and their moments."""
        self.model.load_state_dict(params)
        named = dict(self.model.named_parameters())
        names = list(self.shards)
        sharded = set(self.sharded())
        for k in sharded:
            self.shards[k].copy_(shard_leaf(self.mesh, self.specs[k], named[k]))
        sd = {"state": {}, "param_groups": optimizer_state["param_groups"]}
        for i, slot in optimizer_state["state"].items():
            slot = dict(slot)
            if names[int(i)] in sharded:
                spec = self.specs[names[int(i)]]
                for key in ("exp_avg", "exp_avg_sq"):
                    slot[key] = shard_leaf(self.mesh, spec, slot[key])
            sd["state"][i] = slot
        self.optimizer.load_state_dict(sd)


def create_sharded_train_state(cfg: Config, mesh: Mesh, *, device: torch.device | str = "cuda",
                               params=None) -> tuple[ShardedTrainState, dict]:
    """The train state of ``cfg`` on this rank: the whole model drawn from
    ``cfg.train.seed`` (or loaded from ``params``), as on one device, then
    this rank's shards of every kernel the model axis divides and AdamW
    over them. Returns (state, specs)."""
    base = create_train_state(cfg, device=device, params=params)
    named = dict(base.model.named_parameters())
    specs = tree_shardings(mesh, named)
    tp = mesh.shape[MODEL_AXIS] > 1
    shards = {}
    for k, p in named.items():
        if tp and specs[k]:
            shards[k] = nn.Parameter(shard_leaf(mesh, specs[k], p.detach()).clone())
        else:
            shards[k] = p
    state = ShardedTrainState(
        cfg=cfg, model=base.model, optimizer=build_optimizer(cfg, list(shards.values())),
        generator=base.generator, schedule=base.schedule, step=base.step,
        mesh=mesh, specs=specs, shards=shards,
    )
    return state, specs


def _sum_over(tensors: list[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat ``all_reduce``."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def make_sharded_train_step(cfg: Config, mesh: Mesh):
    """The sharded train step ``step(state, batch, *, plain=False) ->
    metrics``: ``state`` a :class:`ShardedTrainState` (updated in place;
    its specs say what is sharded), ``batch`` the whole global batch (numpy
    or tensors). The metrics are the global ``loss`` and ``grad_norm``
    (before clipping) and the global ``frames``, as device scalars."""
    data_group, model_group = mesh.group(DATA_AXIS), mesh.group(MODEL_AXIS)

    def train_step(state: ShardedTrainState, batch: dict, *, plain: bool = False) -> dict:
        with span("qasr.train_step"):
            model = state.model
            device = next(model.parameters()).device
            n = len(batch["label_lengths"])
            rows = shard_rows(mesh, n)
            local = batch_to_device({k: v[rows] for k, v in batch.items()}, device)
            loss = forward_backward(state, local, plain=plain, tokens=_global_tokens(batch, device),
                                    global_rows=(rows.start, n))
            named = list(model.named_parameters())
            if data_group is not None:
                _sum_over([p.grad for _, p in named], data_group)
            grads = []
            for k, p in named:
                shard = state.shards[k]
                if shard is not p:
                    shard.grad = shard_leaf(mesh, state.specs[k], p.grad)
                grads.append(shard.grad)
            sq = [g.float().square().sum() for g in grads]
            if model_group is not None:
                split = torch.tensor([state.shards[k] is not p for k, p in named], device=device)
                vec = torch.stack(sq)
                part = torch.where(split, vec, torch.zeros_like(vec))
                dist.all_reduce(part, group=model_group)
                sq = list(torch.where(split, part, vec).unbind())
            gnorm = torch.sqrt(sum(sq))
            with span("qasr.optimizer"):
                clip_and_update(state, grads, gnorm)
            state.gather_params()
            if data_group is not None:
                dist.all_reduce(loss, group=data_group)
            frames = int(np.sum(np.asarray(batch["feature_lengths"])))
            return {"loss": loss, "grad_norm": gnorm.detach(),
                    "frames": torch.tensor(frames, device=device)}

    return train_step


def _on_rows(cfg: Config, mesh: Mesh, step):
    """``step`` (``eval_step`` or ``beam_eval_step``) as ``fn(model, batch)``
    on this rank's rows of the global ``batch``, its loss the global
    per-token loss (the same on every rank)."""
    group = mesh.group(DATA_AXIS)

    def sharded(model: nn.Module, batch: dict) -> dict:
        tokens = _global_tokens(batch, next(model.parameters()).device)
        out = step(cfg, model, shard_batch(mesh, batch), tokens=tokens)
        if group is not None:
            dist.all_reduce(out["loss"], group=group)
        return out

    return sharded


def make_sharded_eval_step(cfg: Config, mesh: Mesh):
    """``step(model, batch) -> {loss, decoded, decoded_lengths}``: one
    eval-mode forward of this rank's rows of the global ``batch`` and their
    greedy decode; ``loss`` is the global per-token loss (the same on every
    rank), ``decoded`` the rank's rows (score them against
    :func:`host_rows` of the references)."""
    return _on_rows(cfg, mesh, eval_step)


def make_sharded_beam_decode_step(cfg: Config, mesh: Mesh):
    """As :func:`make_sharded_eval_step`, with the W = ``cfg.decode.beam_width``
    prefix beam on the device instead of the greedy decode (one forward a
    batch; adds ``log_score``). Beams never cross ranks: only the error
    counters do (``qasr_torch.parallel.collectives.aggregate_per``)."""
    return _on_rows(cfg, mesh, beam_eval_step)
