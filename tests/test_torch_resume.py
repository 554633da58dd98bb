"""Resume and model selection in the port, on the CPU.

- ``CheckpointManager``: atomic commits (a save that fails leaves no
  ``step_<n>``), garbage collection of the oldest steps and their
  ``data_state`` sidecars, ``best.json`` moving only on a strictly lower
  ``dev_per``, a collected best falling back to the latest step, and a
  restore that gives back the model, the optimizer, the step and the dropout
  generator bit for bit;
- ``Prefetcher``: the stream's batches in order with the state after each,
  a producer's error re-raised on every later ``next``, ``close``;
- ``MetricWriter`` rows;
- an uninterrupted 10-step ``tiny_synthetic`` run (dropout on) against 5
  steps and ``--resume`` to 10 through the command line: parameters,
  optimizer state, data states and losses bit for bit;
- a run of ``python -m qasr_torch.cli --device cpu`` killed with SIGKILL as
  soon as a checkpoint lands, then resumed to a later step.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from qasr_torch import cli
from qasr_torch.configs import get_config
from qasr_torch.data.batching import BatchStream, Prefetcher
from qasr_torch.data.synthetic import SyntheticDataset
from qasr_torch.train import checkpoint as ckpt_mod
from qasr_torch.train.checkpoint import CheckpointManager
from qasr_torch.train.metrics import MetricWriter, device_memory_stats, per_device_bytes
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import train_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(directory, **over):
    return get_config("tiny_synthetic").override(
        **{"train.checkpoint_dir": str(directory), "model.dropout_rate": 0.1, **over})


def _stream(cfg, seed=0):
    data = SyntheticDataset(vocab=cfg.model.vocab, n_mels=cfg.data.n_mels,
                            num_examples=cfg.data.num_synthetic, seed=seed)
    return BatchStream(data, cfg.data, seed=seed)


def _trained_state(cfg, steps):
    state = create_train_state(cfg, device="cpu")
    stream = _stream(cfg)
    for _ in range(steps):
        train_step(state, next(stream))
    return state


def _assert_same_state(a, b):
    assert a.step == b.step
    for (k, x), (k2, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert k == k2 and torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for p in sa["state"]:
        for n, v in sa["state"][p].items():
            assert torch.equal(v, sb["state"][p][n]), (p, n)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


def test_checkpoint_restore_is_exact(tmp_path):
    cfg = _cfg(tmp_path)
    state = _trained_state(cfg, 3)
    mgr = CheckpointManager(cfg)
    path = mgr.save(3, state, data_state={"epoch": 0, "index": 3})
    assert path == str(tmp_path / "step_3")
    assert sorted(os.listdir(path)) == ["config.json", "params.npz", "train_state.pt"]
    assert json.loads((tmp_path / "config.json").read_text()) == json.loads(cfg.to_json())
    fresh = create_train_state(cfg, device="cpu")
    assert mgr.restore(3, fresh) is fresh
    _assert_same_state(state, fresh)
    assert mgr.restore_data_state(3) == {"epoch": 0, "index": 3}
    assert mgr.restore_data_state(2) is None
    params = mgr.restore_params(3)
    for k, v in state.model.state_dict().items():
        assert torch.equal(params[k], v), k
    # read-only consumers leave the run's config.json alone
    CheckpointManager(cfg.override(**{"train.num_steps": 1}), write_config=False)
    assert json.loads((tmp_path / "config.json").read_text())["train"]["num_steps"] == \
        cfg.train.num_steps


def test_checkpoint_gc_keeps_newest(tmp_path):
    cfg = _cfg(tmp_path, **{"train.keep_checkpoints": 2})
    state = _trained_state(cfg, 1)
    mgr = CheckpointManager(cfg)
    for step in (1, 2, 3, 4):
        mgr.save(step, state, data_state={"epoch": 0, "index": step})
        assert mgr.latest_step() == step
    assert mgr.all_steps() == [3, 4]
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("data_state")) == \
        ["data_state_3.json", "data_state_4.json"]


def test_checkpoint_commit_is_atomic(tmp_path, monkeypatch):
    """A save that dies while writing leaves no ``step_<n>`` (only a
    ``step_<n>.tmp-*`` that no reader lists and the next save removes)."""
    cfg = _cfg(tmp_path)
    state = _trained_state(cfg, 1)
    mgr = CheckpointManager(cfg)
    mgr.save(1, state)
    real = ckpt_mod.save_checkpoint

    def dies_halfway(st, directory):
        torch.save({}, os.path.join(directory, "params.npz"))
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", dies_halfway)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, state, dev_per=0.1)
    assert mgr.all_steps() == [1] and mgr.best_step() is None
    assert any(d.startswith("step_2.tmp-") for d in os.listdir(tmp_path))
    assert cli.resolve_checkpoint(str(tmp_path)) == str(tmp_path / "step_1")
    monkeypatch.setattr(ckpt_mod, "save_checkpoint", real)
    mgr.save(3, state)
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == ["step_1", "step_3"]


def test_best_pointer_moves_only_on_lower_per(tmp_path):
    """``best.json`` follows a strictly lower ``dev_per``; garbage collection
    keeps the step it names beside the newest ``keep_checkpoints``; when that
    step is gone all the same, eval-only and transcribe fall back to the
    latest."""
    cfg = _cfg(tmp_path, **{"train.keep_checkpoints": 3})
    state = _trained_state(cfg, 1)
    mgr = CheckpointManager(cfg)
    seen = []
    for step, per in ((1, 0.5), (2, 0.7), (3, 0.5), (4, None), (5, 0.3), (6, 0.4)):
        mgr.save(step, state, dev_per=per)
        seen.append(mgr.best_step())
    assert seen == [1, 1, 1, 1, 5, 5]
    assert json.loads((tmp_path / "best.json").read_text()) == {"step": 5, "dev_per": 0.3}
    assert cli.resolve_checkpoint(str(tmp_path)) == str(tmp_path / "step_5")
    assert cli.resolve_checkpoint(str(tmp_path), 6) == str(tmp_path / "step_6")
    for step in (7, 8, 9):  # collects step 6, keeps the best step 5
        mgr.save(step, state)
    assert mgr.all_steps() == [5, 7, 8, 9] and mgr.best_step() == 5
    assert cli.resolve_checkpoint(str(tmp_path)) == str(tmp_path / "step_5")
    shutil.rmtree(tmp_path / "step_5")  # the best step removed by hand
    assert mgr.all_steps() == [7, 8, 9] and mgr.best_step() == 5
    assert cli.resolve_checkpoint(str(tmp_path)) == str(tmp_path / "step_9")


# ---------------------------------------------------------------------------
# Prefetcher and MetricWriter
# ---------------------------------------------------------------------------


def test_stream_refuses_an_epoch_without_a_batch(tmp_path):
    """An epoch that fills no batch in any bucket raises a clear error (it
    used to end the stream with a bare StopIteration)."""
    cfg = _cfg(tmp_path, **{"data.num_synthetic": 5})
    with pytest.raises(ValueError, match="fills no batch of 8"):
        next(_stream(cfg))


def test_prefetcher_order_states_and_close(tmp_path):
    cfg = _cfg(tmp_path, **{"data.num_synthetic": 20})
    direct, threaded = _stream(cfg), _stream(cfg)
    pf = Prefetcher(threaded, depth=2)
    for _ in range(7):  # across an epoch boundary (2 batches an epoch)
        batch, state = next(pf)
        want = next(direct)
        assert state == direct.state()
        for k in want:
            np.testing.assert_array_equal(batch[k], want[k])
    assert state["epoch"] >= 2
    pf.close()
    assert not pf._thread.is_alive()


class _Failing:
    def __init__(self, n):
        self.n = n

    def __next__(self):
        if self.n == 0:
            raise ValueError("corrupt utterance")
        self.n -= 1
        return {"i": self.n}

    def state(self):
        return {"left": self.n}


def test_prefetcher_error_is_sticky():
    pf = Prefetcher(_Failing(2), depth=1)
    assert next(pf) == ({"i": 1}, {"left": 1})
    assert next(pf) == ({"i": 0}, {"left": 0})
    for _ in range(2):
        with pytest.raises(RuntimeError, match="prefetch thread failed") as info:
            next(pf)
        assert isinstance(info.value.__cause__, ValueError)
    pf.close()


def test_metric_writer_rows(tmp_path, capsys):
    w = MetricWriter(str(tmp_path / "m"))
    w.write(1, {"loss": np.float32(2.5), "audio_s_per_s_per_chip": 10})
    w.write(2, {"dev_per": 0.25, "note": "x"})
    w.close()
    MetricWriter(str(tmp_path / "m"), console=False).write(3, {"loss": 1.0})
    rows = [json.loads(x) for x in (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert [sorted(r) for r in rows] == [
        ["audio_s_per_s_per_chip", "loss", "step", "step_time_s", "time"],
        ["dev_per", "note", "step", "step_time_s", "time"],
        ["loss", "step", "step_time_s", "time"]]
    assert rows[0]["loss"] == 2.5 and rows[0]["audio_s_per_s_per_chip"] == 10.0
    assert rows[1]["note"] == "x" and rows[1]["time"] >= rows[0]["time"]
    assert all(r["step_time_s"] >= 0 for r in rows)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0].startswith("[qasr] {'step': 1") and "time'" not in out[0]
    state = _trained_state(_cfg(tmp_path), 0)
    assert per_device_bytes((state.model.state_dict(), state.optimizer.state_dict())) == {}
    assert device_memory_stats("cpu") == {}


# ---------------------------------------------------------------------------
# resume through the command line
# ---------------------------------------------------------------------------

SETS = ["train.log_every=1", "train.eval_every=5", "train.checkpoint_every=5",
        "model.dropout_rate=0.1", "data.prefetch_depth=3"]


def _run(directory, steps, *flags):
    return cli.main(["--preset", "tiny_synthetic", "--device", "cpu", *flags, "--set", *SETS,
                     f"train.num_steps={steps}", f"train.checkpoint_dir={directory}"])


def _losses(directory):
    rows = [json.loads(x) for x in (directory / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


def test_resume_equals_uninterrupted_run(tmp_path, capsys):
    whole, split = tmp_path / "whole", tmp_path / "split"
    last = _run(whole, 10)
    _run(split, 5)
    again = _run(split, 10, "--resume")
    assert "resumed from step 5" in capsys.readouterr().out
    mgr_w = CheckpointManager(_cfg(whole), write_config=False)
    mgr_s = CheckpointManager(_cfg(split), write_config=False)
    assert mgr_w.all_steps() == mgr_s.all_steps() == [5, 10]
    for step in (5, 10):
        assert mgr_w.restore_data_state(step) == mgr_s.restore_data_state(step)
    cfg = _cfg(whole)
    a = mgr_w.restore(10, create_train_state(cfg, device="cpu"))
    b = mgr_s.restore(10, create_train_state(cfg, device="cpu"))
    _assert_same_state(a, b)
    assert _losses(whole) == _losses(split) and len(_losses(whole)) == 10
    assert (last["loss"], last["dev_per"]) == (again["loss"], again["dev_per"])
    # a run resumed at its end takes no step
    n_rows = len((split / "metrics.jsonl").read_text().splitlines())
    assert _run(split, 10, "--resume") == {}
    assert len((split / "metrics.jsonl").read_text().splitlines()) == n_rows
    ev = cli.main(["--preset", "tiny_synthetic", "--device", "cpu", "--eval-only", "--set",
                   *SETS, f"train.checkpoint_dir={whole}"])
    assert ev["step"] == CheckpointManager(_cfg(whole), write_config=False).best_step()
    logged = [json.loads(x) for x in (whole / "metrics.jsonl").read_text().splitlines()]
    assert ev["per"] == next(r["dev_per"] for r in logged
                             if r["step"] == ev["step"] and "dev_per" in r)


def _complete_steps(directory):
    return ckpt_mod.steps_in(str(directory))


def test_sigkill_and_resume(tmp_path):
    """SIGKILL a CLI run (no cleanup of any kind) as soon as a checkpoint
    lands; every ``step_<n>`` left is whole, and ``--resume`` continues from
    the latest to a later step."""
    ckpt = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "qasr_torch.cli", "--preset", "tiny_synthetic",
           "--device", "cpu", "--set", "train.checkpoint_every=5", "train.eval_every=1000",
           "train.log_every=5", f"train.checkpoint_dir={ckpt}"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd + ["train.num_steps=100000"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    deadline = time.time() + 120
    try:
        while time.time() < deadline and not _complete_steps(ckpt):
            if proc.poll() is not None:
                pytest.fail(f"train exited before a checkpoint:\n{proc.stdout.read()[-2000:]}")
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL
    killed_at = _complete_steps(ckpt)
    assert killed_at, "no checkpoint appeared within 120 s"
    for step in killed_at:
        assert sorted(os.listdir(ckpt / f"step_{step}")) == \
            ["config.json", "params.npz", "train_state.pt"]
    end = max(killed_at) + 5
    out = subprocess.run(cmd + [f"train.num_steps={end}", "--resume"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert f"resumed from step {max(killed_at)}" in out.stdout
    assert max(_complete_steps(ckpt)) == end
    assert json.loads(out.stdout.splitlines()[-1])["step"] == end


def test_debug_nans_runs_the_loop_under_nan_debug(tmp_path, monkeypatch):
    """``train.debug_nans`` runs the loop inside ``utils.debug.nan_debug``,
    which raises at the first non-finite value an op produces."""
    import contextlib

    from qasr_torch.train.loop import train
    from qasr_torch.utils import debug

    entered = []
    real = debug.nan_debug

    @contextlib.contextmanager
    def recording():
        with real():
            entered.append(torch.overrides._get_current_function_mode() is not None)
            yield

    monkeypatch.setattr(debug, "nan_debug", recording)
    cfg = _cfg(tmp_path, **{"train.debug_nans": True, "train.num_steps": 2,
                            "train.eval_every": 2, "train.checkpoint_every": 2,
                            "train.log_every": 1})
    state, last = train(cfg, device="cpu")
    assert entered == [True] and state.step == 2 and np.isfinite(last["dev_loss"])
    with pytest.raises(FloatingPointError), real():
        torch.log(torch.tensor([-1.0]))
