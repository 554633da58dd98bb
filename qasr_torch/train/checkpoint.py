"""Checkpoints with atomic commits, garbage collection and a best-dev-PER
pointer (counterpart of ``qasr/train/checkpoint.py``).

A checkpoint directory holds, for each kept step ``n``:

- ``step_<n>/``: ``params.npz`` (f32, the JAX package's parameter names),
  ``config.json`` and ``train_state.pt`` (step, optimizer state and the
  dropout generator's state); ``qasr_torch.infer.Transcriber`` serves it as
  it is. It is written as ``step_<n>.tmp-*`` and renamed into place, so a
  killed run never leaves a half-written ``step_<n>``;
- ``data_state_<n>.json``: the batch stream's state after the batch that
  step trained on (``BatchStream.state()``), written before the step
  directory commits;

and beside them ``best.json`` (the step with the lowest ``dev_per`` saved
so far) and the run's ``config.json``. Only the newest
``cfg.train.keep_checkpoints`` steps are kept, and the step ``best.json``
names: the JAX package's Orbax manager collects that step too, and its
model selection then falls back to the latest step under the name of the
best (an older best is the rule once dev PER stops falling).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import torch

from qasr_torch.bridge import load_params_npz, save_params_npz
from qasr_torch.configs import Config

_STEP_DIR = re.compile(r"step_(\d+)")


def _write_atomic(path: str, text: str) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def save_checkpoint(state, directory: str) -> str:
    """Write ``params.npz``, ``config.json`` and ``train_state.pt`` of
    ``state`` (a ``qasr_torch.train.state.TrainState``) into ``directory``;
    returns it."""
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


def steps_in(directory: str) -> list[int]:
    """The committed ``step_<n>`` directories under ``directory``, in order."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1)) for d in os.listdir(directory)
        if (m := _STEP_DIR.fullmatch(d)) and os.path.isdir(os.path.join(directory, d))
    )


def best_step_in(directory: str) -> int | None:
    """The step ``best.json`` under ``directory`` points at, or None."""
    path = os.path.join(directory, "best.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(json.load(f)["step"])


class CheckpointManager:
    """Saves and restores train states under ``directory`` (default
    ``cfg.train.checkpoint_dir``). Read-only consumers pass
    ``write_config=False`` so that they never overwrite the training run's
    ``config.json``."""

    def __init__(self, cfg: Config, *, directory: str | None = None, write_config: bool = True):
        self.cfg = cfg
        self.dir = os.path.abspath(directory or cfg.train.checkpoint_dir)
        self.keep = cfg.train.keep_checkpoints
        os.makedirs(self.dir, exist_ok=True)
        if write_config:
            _write_atomic(os.path.join(self.dir, "config.json"), cfg.to_json())

    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}")

    def save(self, step: int, state, *, dev_per: float | None = None,
             data_state: dict | None = None) -> str:
        """Commit ``state`` as ``step_<step>`` (with its ``data_state``
        sidecar first), move ``best.json`` to it when ``dev_per`` is strictly
        lower than the best so far, and drop the steps beyond the newest
        ``keep_checkpoints`` but the best. Returns the step directory."""
        if data_state is not None:
            _write_atomic(os.path.join(self.dir, f"data_state_{step}.json"),
                          json.dumps(data_state))
        tmp = tempfile.mkdtemp(prefix=f"step_{step}.tmp-", dir=self.dir)
        save_checkpoint(state, tmp)
        final = self.step_dir(step)
        if os.path.isdir(final):  # the same step saved again: replace it whole
            shutil.rmtree(final)
        os.replace(tmp, final)
        if dev_per is not None:
            best_path = os.path.join(self.dir, "best.json")
            best = {"step": -1, "dev_per": float("inf")}
            if os.path.exists(best_path):
                with open(best_path) as f:
                    best = json.load(f)
            if dev_per < best["dev_per"]:
                _write_atomic(best_path, json.dumps({"step": step, "dev_per": float(dev_per)}))
        self._collect(keep_step=step)
        return final

    def _collect(self, keep_step: int) -> None:
        """Remove the steps older than the newest ``keep`` (never
        ``keep_step`` nor the best step), their sidecars, and the temporary
        directories a killed save left."""
        steps = self.all_steps()
        best = self.best_step()
        for s in steps[: max(0, len(steps) - self.keep)]:
            if s not in (keep_step, best):
                shutil.rmtree(self.step_dir(s), ignore_errors=True)
                try:
                    os.remove(os.path.join(self.dir, f"data_state_{s}.json"))
                except FileNotFoundError:
                    pass
        for d in os.listdir(self.dir):
            if ".tmp-" in d and d.startswith("step_"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def all_steps(self) -> list[int]:
        return steps_in(self.dir)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> int | None:
        """The step with the lowest ``dev_per`` saved so far; it may have
        been collected since (check ``all_steps``)."""
        return best_step_in(self.dir)

    def restore(self, step: int, state):
        """Load ``step_<step>`` into ``state`` in place (the model's weights,
        the optimizer's state, the step count and the dropout generator);
        returns it."""
        d = self.step_dir(step)
        params = load_params_npz(os.path.join(d, "params.npz"))
        state.model.load_state_dict(params)
        saved = torch.load(os.path.join(d, "train_state.pt"), map_location="cpu",
                           weights_only=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.generator.set_state(saved["generator"])
        state.step = int(saved["step"])
        return state

    def restore_params(self, step: int) -> dict[str, torch.Tensor]:
        """The weights of ``step_<step>`` as a state_dict (CPU tensors)."""
        return load_params_npz(os.path.join(self.step_dir(step), "params.npz"))

    def restore_data_state(self, step: int) -> dict | None:
        path = os.path.join(self.dir, f"data_state_{step}.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return None
