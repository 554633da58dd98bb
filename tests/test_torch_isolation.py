"""qasr_torch runs without JAX and without the JAX package: the machine with
the GPU has no JAX, and the port keeps its own copies of what it needs.

A subprocess blocks jax/flax/optax/orbax, ``qasr`` itself and
``benchmarks`` in ``sys.modules`` before importing the port, then serves a
small qcnn and a small qlstm on the CPU end to end (greedy and beam), trains
``tiny_synthetic`` and the small qlstm for two steps each, trains and
serves through the command line (``qasr_torch.cli``), runs kernel J's plain
version through ``qasr_torch.utils``, imports ``qasr_torch.tools.probe_dgt``
and serves a small real CNN, and trains and evaluates a small QCNN on a
mini-TIMIT corpus that the port's own writer makes, then beam-decodes it
through the TIMIT protocol tool; a source scan checks
that no file of the port (or chip_smoke.py) imports any of them, nor the
JAX package's probes (``benchmarks``).
"""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint", "qasr", "benchmarks"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
import qasr_torch
for name in qasr_torch.__all__:
    getattr(qasr_torch, name)  # every public symbol resolves without JAX
from qasr_torch.configs import get_config
from qasr_torch.data.batching import BatchStream
from qasr_torch.data.synthetic import SyntheticDataset
from qasr_torch.infer import Transcriber
from qasr_torch.models import build_model
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import train_step

cfg = get_config("timit_qcnn").override(**{
    "model.conv_features": (8, 16), "model.dense_features": (8,),
    "model.compute_dtype": "float32", "data.n_mels": 8,
    "data.bucket_sizes": (64,), "decode.beam_width": 4,
})
params = build_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu").state_dict()
wavs = [np.random.default_rng(i).standard_normal(4000 + 999 * i).astype(np.float32) * 0.1
        for i in range(2)]
for beam in (False, True):
    out = Transcriber(cfg=cfg, params=params, beam=beam, device="cpu").transcribe_batch(wavs)
    assert len(out) == 2 and all(isinstance(p, str) for seq in out for p in seq), out

qcfg = get_config("librispeech_qlstm").override(**{
    "model.conv_features": (8, 8), "model.lstm_features": 16, "model.lstm_layers": 1,
    "model.dense_features": (8,), "model.vocab": 12, "model.compute_dtype": "float32",
    "data.n_mels": 8, "data.bucket_sizes": (64,), "decode.beam_width": 4,
})
qparams = build_model(qcfg, generator=torch.Generator().manual_seed(0), device="cpu").state_dict()
for beam in (False, True):
    out = Transcriber(cfg=qcfg, params=qparams, beam=beam, device="cpu").transcribe_batch(wavs)
    assert len(out) == 2 and all(isinstance(s, str) for s in out), out

tcfg = get_config("tiny_synthetic")
data = SyntheticDataset(vocab=tcfg.model.vocab, n_mels=tcfg.data.n_mels,
                        num_examples=tcfg.data.num_synthetic, seed=0)
stream = BatchStream(data, tcfg.data, seed=0)
state = create_train_state(tcfg, device="cpu")
for _ in range(2):
    m = train_step(state, next(stream))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])), m
assert state.step == 2

qtcfg = qcfg.override(**{"data.dataset": "synthetic", "data.batch_size": 2,
                         "data.max_label_len": 16, "train.warmup_steps": 1})
qdata = SyntheticDataset(vocab=qtcfg.model.vocab, n_mels=qtcfg.data.n_mels,
                         num_examples=8, seed=0)
qstream = BatchStream(qdata, qtcfg.data, seed=0)
qstate = create_train_state(qtcfg, device="cpu")
for _ in range(2):
    m = train_step(qstate, next(qstream))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])), m
assert qstate.step == 2
import tempfile
import wave
from qasr_torch.cli import main, transcribe_main
with tempfile.TemporaryDirectory() as d:
    last = main(["--preset", "tiny_synthetic", "--device", "cpu", "--set", "train.num_steps=1",
                 "train.eval_every=1", "model.op_variant=fused", "model.dense_variant=pallas",
                 f"train.checkpoint_dir={d}"])
    with wave.open(f"{d}/a.wav", "wb") as f:
        f.setnchannels(1); f.setsampwidth(2); f.setframerate(16000)
        f.writeframes((wavs[0] * 20000).astype(np.int16).tobytes())
    out = transcribe_main(["--ckpt", d, "--device", "cpu", f"{d}/a.wav"])
    assert len(out) == 1 and np.isfinite(last["dev_loss"]), (out, last)
import qasr_torch.tools.probe_dgt
from qasr_torch.ops.kernels.dgt import dgt
from qasr_torch.utils import checkify_fn, steady_state_time
x, y = torch.randn(64, 16), torch.randn(64, 8)
err, out = checkify_fn(dgt)(x, y, mode="dgt")
err.throw()
assert torch.allclose(out, x.T @ y, rtol=1e-5, atol=1e-5)
assert steady_state_time(lambda n: 0.5 + 0.01 * n, repeats=1) > 0
rcfg = cfg.override(**{"model.arch": "real_cnn", "model.conv_features": (4, 8)})
rparams = build_model(rcfg, generator=torch.Generator().manual_seed(0), device="cpu").state_dict()
out = Transcriber(cfg=rcfg, params=rparams, device="cpu").transcribe_batch(wavs)
assert len(out) == 2, out
from qasr_torch.tools.make_mini_timit import write_corpus
with tempfile.TemporaryDirectory() as d:
    write_corpus(f"{d}/timit", train_speakers=2, utts_per_speaker=4, dev_speakers=1,
                 test_speakers=1)
    sets = ["--set", f"data.data_dir={d}/timit", "data.batch_size=2", "data.bucket_sizes=256",
            "model.conv_features=4,4", "model.dense_features=8", "model.compute_dtype=float32",
            "train.num_steps=2", "train.eval_every=2", "train.checkpoint_every=2",
            f"train.checkpoint_dir={d}/ckpt"]
    last = main(["--preset", "timit_qcnn_fm32", "--device", "cpu", *sets])
    ev = main(["--preset", "timit_qcnn_fm32", "--device", "cpu", "--eval-only", *sets])
    assert ev["step"] == 2 and ev["per"] == last["dev_per"], (ev, last)
    from qasr_torch.tools.run_timit_protocol import main as protocol
    line = protocol(["--device", "cpu", "--data-dir", f"{d}/timit", "--ckpt", f"{d}/ckpt",
                     "--preset", "timit_qcnn_fm32", "--skip-train", *sets, "decode.beam_width=4"])
    assert line["step"] == 2 and line["beam_width"] == 4 and not line["trained_here"], line
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "qasr",
                                                              "benchmarks")
                and sys.modules[m] is not None)
print("OK", loaded)
"""


def test_port_serves_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK []" in proc.stdout


# any import of JAX, of the JAX package (``qasr``, ``qasr.x``) or of its
# probes (``benchmarks``), not of ``qasr_torch``
_FORBIDDEN = re.compile(
    r"^[ \t]*(?:import|from)[ \t]+(?:jax|jaxlib|flax|optax|orbax|qasr|benchmarks)\b",
    re.MULTILINE,
)


def test_no_jax_imports_in_port_sources():
    for line in ("import qasr", "from qasr.configs import get_config", "import qasr.native",
                 "    from qasr import native", "import jax.numpy as jnp",
                 "from benchmarks import probe_dgt"):
        assert _FORBIDDEN.search(line), line
    for line in ("import qasr_torch", "from qasr_torch.configs import Config"):
        assert not _FORBIDDEN.search(line), line
    files = sorted((REPO / "qasr_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and REPO / "qasr_torch" / "cli.py" in files
    for part in ("utils/__init__.py", "utils/profiling.py", "utils/debug.py",
                 "ops/kernels/dgt.py", "tools/probe_dgt.py", "data/pipeline.py",
                 "train/checkpoint.py", "train/metrics.py", "tools/make_mini_timit.py",
                 "tools/make_mini_librispeech.py", "tools/run_timit_protocol.py",
                 "decode/beam.py"):
        assert REPO / "qasr_torch" / part in files, part
    bad = {
        str(f.relative_to(REPO)): _FORBIDDEN.findall(f.read_text())
        for f in files
        if _FORBIDDEN.search(f.read_text())
    }
    assert not bad, bad
