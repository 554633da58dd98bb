"""``python -m qasr_torch.tools.run_timit_protocol``, the port's TIMIT
acceptance protocol, on the CPU: a tiny mini-TIMIT from the port's writer,
``timit_qcnn_fm32`` narrowed through ``--set`` and trained 40 steps at a
peak rate of 3e-3. An untrained model's logits are nearly flat (std ~0.3
over 62 classes), and then candidates at the beam's 100th place tie within
the f32 drift between the two packages' ``exp`` and ``log`` (~1e-5 a
score), so either package may keep either; 40 steps leave that regime
(logit std ~2, dev PER ~0.8).

- stdout is one JSON line with the reference tool's keys, letter for letter
  (read from ``tools/run_timit_protocol.py``'s source, so the JAX tool is
  not run);
- the selected step is ``best.json``'s, the lowest ``dev_per`` logged;
- ``--skip-train`` prints the same PERs exactly;
- ``dev_per`` equals ``qasr.train.evaluate(beam=True)`` on the selected
  checkpoint's weights carried to JAX by ``params_to_jax`` (rounded to the
  line's four places).
"""

import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from qasr.configs import get_config as jget_config
from qasr.data.pipeline import TimitFeaturePipeline as JTimitFeaturePipeline
from qasr.train import evaluate as jevaluate
from qasr_torch.bridge import params_to_jax
from qasr_torch.configs import get_config
from qasr_torch.tools import run_timit_protocol
from qasr_torch.tools.make_mini_timit import write_corpus
from qasr_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVER = {"data.batch_size": 4, "model.conv_features": "8,8", "model.dense_features": "16",
        "model.compute_dtype": "float32", "model.dropout_rate": 0.0, "train.num_steps": 40,
        "train.eval_every": 20, "train.checkpoint_every": 20, "train.log_every": 10,
        "train.warmup_steps": 4, "train.learning_rate": 3e-3}


def _reference_keys() -> list[str]:
    """The keys of the dict the reference tool passes to ``json.dumps``."""
    tree = ast.parse(open(os.path.join(REPO, "tools", "run_timit_protocol.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps({...}) in tools/run_timit_protocol.py")


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    root = tmp_path_factory.mktemp("protocol")
    data, ckpt = str(root / "timit"), str(root / "ckpt")
    write_corpus(data, train_speakers=3, utts_per_speaker=4, dev_speakers=2, test_speakers=2)
    argv = ["--device", "cpu", "--data-dir", data, "--ckpt", ckpt, "--preset", "timit_qcnn_fm32",
            "--set", *[f"{k}={v}" for k, v in OVER.items()]]
    proc = subprocess.run(
        [sys.executable, "-m", "qasr_torch.tools.run_timit_protocol", *argv], cwd=REPO,
        # one intra-op thread, as this process: beside other test workers a
        # process with a thread a core runs many times slower
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return argv, data, ckpt, proc.stdout


def test_one_json_line_with_the_reference_keys(protocol):
    argv, data, ckpt, stdout = protocol
    lines = stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == _reference_keys()
    assert line["protocol"] == "timit_per" and line["preset"] == "timit_qcnn_fm32"
    assert (line["beam_width"], line["beam_prune_logp"]) == (100, -20.0)
    assert line["fold"] == "lee_hon_61_to_39" and line["data_dir"] == data
    assert line["trained_here"] is True and line["selected_by"] == "best_dev_per"
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        dev = {r["step"]: r["dev_per"] for r in map(json.loads, f) if "dev_per" in r}
    assert sorted(dev) == [20, 40] and line["step"] == min(dev, key=lambda s: (dev[s], s))
    assert np.isfinite(line["dev_per"]) and np.isfinite(line["test_per"])


def test_skip_train_repeats_the_pers(protocol):
    argv, _, _, stdout = protocol
    first = json.loads(stdout)
    out = io.StringIO()
    with redirect_stdout(out):
        again = run_timit_protocol.main([*argv, "--skip-train"])
    assert json.loads(out.getvalue()) == again
    assert again["trained_here"] is False and again["step"] == first["step"]
    assert (again["dev_per"], again["test_per"]) == (first["dev_per"], first["test_per"])


def test_dev_per_equals_jax_beam_evaluate(protocol):
    _, data, ckpt, stdout = protocol
    line = json.loads(stdout)
    over = {**OVER, "data.data_dir": data, "train.checkpoint_dir": ckpt}
    tcfg = get_config("timit_qcnn_fm32").override(**over)
    jcfg = jget_config("timit_qcnn_fm32").override(**over)
    params = CheckpointManager(tcfg, write_config=False).restore_params(line["step"])
    jparams = jax.tree.map(np.asarray, params_to_jax(params))
    want = jevaluate(jcfg, jparams, JTimitFeaturePipeline(jcfg, "dev"), None, beam=True)
    assert round(want["per"], 4) == line["dev_per"]
