"""``qasr_torch.cli``, the port's command line, on the CPU: ``main`` trains a
preset with overrides and writes a checkpoint, ``transcribe_main`` serves it
on written wav files (greedy and beam), ``--resume``, ``--eval-only`` and
``--eval-only --beam`` run, and ``python -m qasr_torch.cli`` dispatches
both."""

import json
import os
import shutil
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from qasr_torch.bridge import load_params_npz
from qasr_torch.cli import main, resolve_checkpoint, transcribe_main
from qasr_torch.configs import Config
from qasr_torch.models import build_model
from qasr_torch.train.loop import build_eval_dataset, evaluate

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = ["train.num_steps=2", "train.log_every=1", "train.eval_every=2",
        "train.checkpoint_every=2", "model.op_variant=fused", "model.dense_variant=pallas"]


def _write_wav(path, seconds, seed):
    pcm = (np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 2000).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps of tiny_synthetic in the 10-product routing, through main."""
    root = tmp_path_factory.mktemp("cli")
    last = main(["--preset", "tiny_synthetic", "--device", "cpu",
                 "--set", *SETS, f"train.checkpoint_dir={root}"])
    return root, last


def test_main_trains_and_writes_a_checkpoint(trained, capsys):
    root, last = trained
    assert np.isfinite(last["loss"]) and "dev_per" in last
    assert last["checkpoint"] == str(root / "step_2")
    cfg = Config.from_json((root / "step_2" / "config.json").read_text())
    assert (cfg.model.op_variant, cfg.model.dense_variant) == ("fused", "pallas")
    assert cfg.train.num_steps == 2 and cfg.train.checkpoint_dir == str(root)
    assert (root / "step_2" / "params.npz").exists()
    rows = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 2]


def test_transcribe_main_serves_the_checkpoint(trained, tmp_path, capsys):
    root, _ = trained
    wavs = [_write_wav(tmp_path / f"u{i}.wav", 0.4 + 0.3 * i, i) for i in range(2)]
    capsys.readouterr()
    greedy = transcribe_main(["--ckpt", str(root), "--device", "cpu", *wavs])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("\t")[0] for ln in lines] == wavs
    assert len(greedy) == 2 and all(isinstance(p, str) for seq in greedy for p in seq)
    beam = transcribe_main(["--ckpt", str(root / "step_2"), "--device", "cpu", "--beam",
                            "--fold", wavs[0]])
    assert len(beam) == 1 and all(isinstance(p, str) for p in beam[0])


def test_resolve_checkpoint(trained, tmp_path):
    root, _ = trained
    assert resolve_checkpoint(str(root)) == str(root / "step_2")
    assert resolve_checkpoint(str(root), 2) == str(root / "step_2")
    assert resolve_checkpoint(str(root / "step_2")) == str(root / "step_2")
    with pytest.raises(SystemExit, match="no step_3"):
        resolve_checkpoint(str(root), 3)
    with pytest.raises(SystemExit, match="no checkpoint"):
        resolve_checkpoint(str(tmp_path))


def test_resume_eval_only_beam_eval_and_bad_flags(trained, tmp_path, capsys):
    """``--resume`` and ``--eval-only`` run and corpus datasets are accepted;
    ``--eval-only --beam`` reports the ``per`` and loss that
    ``evaluate(beam=True)`` gives on that step; a missing corpus or
    checkpoint, a bad ``--set`` and ``--list-presets`` behave as before."""
    root, first = trained
    run = tmp_path / "run"
    shutil.copytree(root, run)
    again = main(["--preset", "tiny_synthetic", "--device", "cpu", "--resume", "--set", *SETS,
                  "train.num_steps=4", f"train.checkpoint_dir={run}"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and json.loads(out.splitlines()[-1])["step"] == 4
    assert again["checkpoint"] == str(run / "step_4") and np.isfinite(again["dev_per"])
    ev = main(["--preset", "tiny_synthetic", "--device", "cpu", "--eval-only", "--set", *SETS,
               f"train.checkpoint_dir={root}"])
    assert ev["step"] == 2 and ev["per"] == first["dev_per"]
    np.testing.assert_allclose(ev["loss"], first["dev_loss"], rtol=1e-6)
    assert "eval @ step 2: " in capsys.readouterr().out
    beam = main(["--preset", "tiny_synthetic", "--device", "cpu", "--eval-only", "--beam",
                 "--set", *SETS, f"train.checkpoint_dir={root}"])
    assert "eval @ step 2: " in capsys.readouterr().out
    cfg = Config.from_json((root / "step_2" / "config.json").read_text())
    model = build_model(cfg, device="cpu")
    model.load_state_dict(load_params_npz(str(root / "step_2" / "params.npz")))
    want = evaluate(cfg, model, build_eval_dataset(cfg, device="cpu"), beam=True)
    assert beam == {"step": 2, **want} and 0.0 < want["per"]
    with pytest.raises(FileNotFoundError, match="TIMIT root"):
        main(["--preset", "timit_qcnn", "--device", "cpu", "--set",
              f"data.data_dir={tmp_path / 'no_timit'}"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(["--device", "cpu", "--eval-only", "--set", f"train.checkpoint_dir={tmp_path / 'e'}"])
    with pytest.raises(SystemExit, match="key.path=value"):
        main(["--device", "cpu", "--set", "train.num_steps"])
    main(["--list-presets"])
    out = capsys.readouterr().out
    assert "timit_qcnn: arch=qcnn dataset=timit" in out and "librispeech_qlstm" in out


def test_module_entry_dispatches_transcribe(trained, tmp_path):
    """``python -m qasr_torch.cli transcribe ...`` in a fresh process."""
    root, _ = trained
    wav = _write_wav(tmp_path / "m.wav", 0.5, 7)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "qasr_torch.cli", "transcribe", "--ckpt", str(root),
         "--device", "cpu", wav],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith(f"{wav}\t")


def test_eval_only_defaults_to_the_train_split(tmp_path, capsys):
    """``--eval-only`` with no ``--split`` scores the train split
    (``build_dataset(cfg)``), as the JAX package's does (``qasr/cli.py:74``),
    and its line names the split; ``--split dev`` scores the set the loop
    logged its ``dev_per`` on."""
    from qasr_torch.tools.make_mini_timit import write_corpus
    from qasr_torch.train.loop import build_dataset

    write_corpus(str(tmp_path / "timit"), train_speakers=2, utts_per_speaker=4, dev_speakers=1,
                 test_speakers=1)
    sets = ["--set", f"data.data_dir={tmp_path / 'timit'}", "data.batch_size=2",
            "data.bucket_sizes=256", "model.conv_features=4,4", "model.dense_features=8",
            "model.compute_dtype=float32", "train.num_steps=2", "train.eval_every=2",
            "train.checkpoint_every=2", f"train.checkpoint_dir={tmp_path / 'ckpt'}"]
    last = main(["--preset", "timit_qcnn_fm32", "--device", "cpu", *sets])
    capsys.readouterr()
    ev = main(["--preset", "timit_qcnn_fm32", "--device", "cpu", "--eval-only", *sets])
    assert "eval @ step 2: " in (out := capsys.readouterr().out) and "(split train)" in out, out
    cfg = Config.from_json((tmp_path / "ckpt" / "step_2" / "config.json").read_text())
    model = build_model(cfg, device="cpu")
    model.load_state_dict(load_params_npz(str(tmp_path / "ckpt" / "step_2" / "params.npz")))
    assert ev == {"step": 2, **evaluate(cfg, model, build_dataset(cfg, device="cpu"))}
    dev = main(["--preset", "timit_qcnn_fm32", "--device", "cpu", "--eval-only", "--split", "dev",
                *sets])
    assert "(split dev)" in capsys.readouterr().out
    assert dev["per"] == last["dev_per"] and ev["per"] != dev["per"], (ev, dev, last)
