"""qasr_torch runs without JAX: the machine with the GPU has none.

A subprocess blocks jax/flax/optax/orbax in ``sys.modules`` before importing
the port, then serves a small model on the CPU end to end; a source scan
checks that no file of the port (or chip_smoke.py) imports them, or the
JAX-backed modules of ``qasr``.
"""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "orbax.checkpoint"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
import qasr_torch
for name in qasr_torch.__all__:
    getattr(qasr_torch, name)  # every public symbol resolves without JAX
from qasr.configs import get_config
from qasr_torch.models import build_model
from qasr_torch.infer import Transcriber

cfg = get_config("timit_qcnn").override(**{
    "model.conv_features": (8, 16), "model.dense_features": (8,),
    "model.compute_dtype": "float32", "data.n_mels": 8,
    "data.bucket_sizes": (64,), "decode.beam_width": 4,
})
params = build_model(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
wavs = [np.random.default_rng(i).standard_normal(4000 + 999 * i).astype(np.float32) * 0.1
        for i in range(2)]
for beam in (False, True):
    out = Transcriber(cfg=cfg, params=params, beam=beam, device="cpu").transcribe_batch(wavs)
    assert len(out) == 2 and all(isinstance(p, str) for seq in out for p in seq), out
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "orbax")
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
    assert "OK" in proc.stdout


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax)\b"
    r"|^\s*(?:import|from)\s+qasr\.(?:ops|models|features|decode|train|infer|parallel|utils)\b",
    re.MULTILINE,
)


def test_no_jax_imports_in_port_sources():
    files = sorted((REPO / "qasr_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = {
        str(f.relative_to(REPO)): _FORBIDDEN.findall(f.read_text())
        for f in files
        if _FORBIDDEN.search(f.read_text())
    }
    assert not bad, bad
