"""The training loop: ``qasr_torch.train.step.train_step`` on one
``create_train_state`` state, fed the mix's numpy batches one step after
another (the host-to-device copy inside the window, as in the training
loop).

Set-up builds the state from the benchmark's seeded weights and dropout
generator, drives it through the first three steps on the first three
batches (rows that all differ), keeping what the check compares (each loss,
the first step's logits, read by a hook on the model's call, and its
gradient as AdamW took it, the parameters after step three), then steps on
until every batch shape has run twice. The window continues with the same
state. The check re-runs the three steps in the plain reference from the
same weights, batches and dropout draws, in blocks of rows where the
configuration's optional ``"check": {"rows_per_block": n}`` asks for them
(so that the reference's saved tensors fit beside a batch that fills the
card); the program never sees that group."""

from __future__ import annotations

import torch

from qbench import checks
from qbench.reference import model as ref_model
from qbench.reference.precision import exact_f32
from qbench.reference.train import train_steps
from qbench.traffic import utterances

#: steps the check compares
COMPARED = 3
#: the traced run's profiled stretch, in steps
PROFILE_ITEMS = 4


def rows_per_block(conf: dict) -> int | None:
    """The configuration's ``check.rows_per_block``: the reference runs each
    compared batch in blocks of that many rows (None: the whole batch in one
    pass)."""
    n = conf.get("check", {}).get("rows_per_block")
    if n is not None and (isinstance(n, bool) or not isinstance(n, int) or n < 1):
        raise ValueError(f"check.rows_per_block must be a positive integer, not {n!r}")
    return n


def program_config(conf: dict, seed: int):
    """The program's ``Config`` for a configuration file: the preset, with
    every value the file states set over it."""
    from qasr_torch.configs import get_config

    flat = {}
    for group in ("model", "data", "train", "decode"):
        for k, v in conf.get(group, {}).items():
            flat[f"{group}.{k}"] = tuple(v) if isinstance(v, list) else v
    flat["train.seed"] = seed
    return get_config(conf["preset"]).override(**flat)


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.rows_per_block = rows_per_block(ctx.conf)
        self.state = None
        self.i = 0
        self.losses = []

    def _seeds(self):
        s = self.ctx.seed
        return (utterances.subseed(s, "weights") % 2**62, utterances.subseed(s, "dropout") % 2**62,
                utterances.subseed(s, "init") % 2**31)

    def prepare(self):
        """The batches, from the seed (what the reference needs too)."""
        conf, mix = self.ctx.conf, self.ctx.mix
        if list(mix["buckets"]) != list(conf["data"]["bucket_sizes"]):
            raise ValueError("the mix's buckets are not the configuration's bucket_sizes")
        self.pool = utterances.train_pool(mix, self.ctx.seed, conf["data"]["n_mels"])

    def setup(self):
        from qasr_torch.train.state import create_train_state
        from qasr_torch.train.step import train_step

        ctx, dev = self.ctx, self.ctx.device
        conf = ctx.conf
        self.prepare()
        wseed, dseed, iseed = self._seeds()
        self.cfg = program_config(conf, iseed)
        params = ref_model.make_params(conf["model"], conf["data"]["n_mels"], wseed, dev)
        self.state = create_train_state(self.cfg, device=dev, params=params)
        del params
        self.state.generator = torch.Generator(device=dev).manual_seed(dseed)
        self.train_step = train_step
        named = dict(self.state.model.named_parameters())
        first_losses, seen_logits = [], []
        hook = self.state.model.register_forward_hook(
            lambda mod, args, out: seen_logits.append(out.detach().clone()))
        for i in range(COMPARED):
            out = train_step(self.state, self.pool[i])
            first_losses.append(out["loss"])
            if i == 0:
                hook.remove()
                self.logits = seen_logits[0]
                opt = self.state.optimizer.state
                # AdamW's first moment after one step is (1 - b1) g
                self.grad_norms = {k: float(torch.linalg.vector_norm(opt[p]["exp_avg"]) / 0.1)
                                   if p in opt else 0.0 for k, p in named.items()}
        self.after = {k: p.detach().clone() for k, p in named.items()}
        self.first_losses = [float(x) for x in first_losses]
        self.i = COMPARED
        seen: dict[int, int] = {}
        for b in self.pool[:COMPARED]:
            t = b["features"].shape[1]
            seen[t] = seen.get(t, 0) + 1
        shapes = {b["features"].shape[1] for b in self.pool}
        while any(seen.get(t, 0) < 2 for t in shapes) and self.i < 4 * len(self.pool):
            b = self.pool[self.i % len(self.pool)]
            t = b["features"].shape[1]
            if seen.get(t, 0) < 2:
                train_step(self.state, b)
                seen[t] = seen.get(t, 0) + 1
            self.i += 1

    def step(self) -> dict:
        b = self.pool[self.i % len(self.pool)]
        self.i += 1
        out = self.train_step(self.state, b)
        self.losses.append(out["loss"])
        return {"audio_s": b["audio_s"], "real_frames": int(b["feature_lengths"].sum()),
                "rows": len(b["feature_lengths"]), "t_pad": b["features"].shape[1]}

    def sync(self):
        if self.ctx.device.startswith("cuda"):
            torch.cuda.synchronize()

    def outcome(self) -> tuple[int, int]:
        if not self.losses:
            return 0, 0
        bad = int((~torch.isfinite(torch.stack(self.losses))).sum())
        return len(self.losses), bad

    def release(self):
        self.state = None
        self.losses = []

    def reference(self, prec: str = "f32") -> dict:
        """The reference's losses, first gradients and changes over the
        compared steps, in ``prec``, in the configuration's blocks of rows."""
        ctx, dev = self.ctx, self.ctx.device
        wseed, dseed, _ = self._seeds()
        params = ref_model.make_params(ctx.conf["model"], ctx.conf["data"]["n_mels"], wseed, dev)
        gen = torch.Generator(device=dev).manual_seed(dseed)
        with exact_f32():
            ref = train_steps(params, ctx.conf["model"], ctx.conf["train"],
                              self.pool[:COMPARED], gen, dev, prec=prec,
                              rows_per_block=self.rows_per_block, remat=True)
        return {"losses": ref["losses"], "grad_norms": checks.norms(ref["first_grads"]),
                "change_norms": checks.norms(ref["change"]), "logits": ref["logits"],
                "lengths": self.pool[0]["feature_lengths"], "params": params}

    def program_readings(self, params0: dict) -> dict:
        change = {k: self.after[k] - params0[k] for k in self.after}
        return {"losses": self.first_losses, "grad_norms": self.grad_norms,
                "change_norms": checks.norms(change), "logits": self.logits,
                "lengths": self.pool[0]["feature_lengths"]}

    def check(self) -> dict:
        ref = self.reference()
        prog = self.program_readings(ref.pop("params"))
        return checks.train_numbers(prog, ref)
