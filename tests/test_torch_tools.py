"""The config-5 tools against the JAX package's: ``memory_envelope``'s
argument bytes, ``run_scaling_table``'s line, ``find_rank8``, the port's
random batch, and the command line's choice of card and backend under
``torch.distributed.run``.

The reference tools run on the JAX package and a TPU, so what is held here
is what the two can share on the CPU: the parameter bytes the envelope
counts (the JAX package's, from ``jax.eval_shape`` of its init, exactly),
the scaling table's JSON keys (read with ``ast`` from
``tools/run_scaling_table.py``, whose import would start JAX on a device),
and the rank-8 search's result (the scheme both packages embed, exactly).
The peak itself is a card's and has no host mode: the CPU call raises.
"""

import ast
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from qasr.configs import get_config as jget_config
from qasr.train.state import build_model as jbuild_model
from qasr_torch import cli
from qasr_torch.configs import get_config
from qasr_torch.data.synthetic import random_batch
from qasr_torch.models import build_model
from qasr_torch.ops.quaternion import O8, U8, V8
from qasr_torch.tools import find_rank8, memory_envelope, run_scaling_table
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import batch_to_device, train_step

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_param_bytes(cfg, t=64) -> int:
    """The JAX package's parameter bytes for ``cfg`` (f32 master weights),
    from the shapes of its init (no compile)."""
    model = jbuild_model(cfg)
    x = jax.ShapeDtypeStruct((1, t, cfg.data.n_mels, 4), jnp.float32)
    shapes = jax.eval_shape(lambda k, f: model.init(k, f, train=False), jax.random.PRNGKey(0), x)
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for s in jax.tree.leaves(shapes["params"]))


def test_config5_parameters_match_jax():
    """Config 5 at full width holds the JAX package's parameter bytes
    (36.2 M f32 parameters)."""
    jcfg, tcfg = jget_config("librispeech_large"), get_config("librispeech_large")
    model = build_model(tcfg, device="cpu")
    port = sum(p.numel() * p.element_size() for p in model.parameters())
    assert port == _jax_param_bytes(jcfg)
    assert round(port / 4 / 1e6, 1) == 36.2


def test_envelope_argument_bytes_are_three_states_and_the_batch():
    """After one step (AdamW's moments exist), the envelope's argument bytes
    are 3x the JAX package's parameter bytes plus the batch's; the batch is
    the preset's labels padded to ``max_label_len``."""
    over = {"model.conv_features": (8, 16), "model.dense_features": (16,),
            "model.compute_dtype": "float32", "data.max_label_len": 12}
    tcfg = get_config("librispeech_large").override(**over)
    jcfg = jget_config("librispeech_large").override(**over)
    raw = memory_envelope.point_batch(tcfg, 2, 32)
    assert raw["labels"].shape == (2, 12) and int(raw["label_lengths"][0]) == 32 // 8
    state = create_train_state(tcfg, device="cpu")
    batch = batch_to_device(raw, torch.device("cpu"))
    train_step(state, batch)
    batch_bytes = sum(t.numel() * t.element_size() for t in batch.values())
    assert memory_envelope.argument_bytes(state, batch) == (
        3 * _jax_param_bytes(jcfg) + batch_bytes)


def test_envelope_refuses_the_host():
    """No host numbers under a device metric's name: the CPU raises."""
    with pytest.raises(ValueError, match="CUDA card"):
        memory_envelope.measure_point(get_config("librispeech_large"), 2, 32, False,
                                      device="cpu")
    with pytest.raises(ValueError, match="CUDA card"):
        memory_envelope.main(["--device", "cpu", "--points", "2:32"])
    assert [tuple(int(v) for v in p.split(":")) for p in memory_envelope.POINTS.split(",")] == [
        (4, 2048), (8, 2048), (16, 2048), (16, 1024), (32, 1024), (64, 512), (64, 2048)]
    row = {"b": 8, "t": 512, "remat": True, "args_gb": 0.4, "temp_gb": 1.0, "total_gb": 1.4,
           "fits": True}
    assert memory_envelope.format_row(row, 80.0) == (
        "B8 T512 remat=1: args 0.40 GB + temps 1.00 GB = 1.40 GB FITS (of 80 GB)")


def _reference_keys() -> tuple[list[str], list[str]]:
    """The keys of the line ``tools/run_scaling_table.py`` passes to
    ``json.dumps``, and of its rows."""
    tree = ast.parse(open(os.path.join(REPO, "tools", "run_scaling_table.py")).read())
    line = rows = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            line = [k.value for k in node.args[0].keys]
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "append"
                and node.args and isinstance(node.args[0], ast.Dict)):
            rows = [k.value for k in node.args[0].keys]
    assert line and rows, "no json.dumps({...}) or rows.append({...})"
    return line, rows


def test_scaling_table_world_of_one(capsys):
    """A world of one on the CPU: one finite row of efficiency 1.0, the
    reference's keys in the line and the row, one JSON line printed."""
    line = run_scaling_table.main([
        "--device", "cpu", "--preset", "tiny_synthetic", "--b-per-chip", "2", "--t", "32",
        "--n-small", "1", "--n-big", "2"])
    ref_line, ref_row = _reference_keys()
    assert list(line) == ref_line
    assert line["backend"] == "cpu" and len(line["rows"]) == 1
    row = line["rows"][0]
    assert list(row) == ref_row
    assert row["chips"] == row["hosts"] == 1 and row["efficiency"] == 1.0
    assert math.isfinite(row["step_ms"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith('{"protocol": "dp_weak_scaling"')


def test_find_rank8_reproduces_the_embedded_scheme():
    """Seed 8 of the search (kv 2, ko 16) is exact and is the U8/V8/O8
    scheme both packages embed."""
    u, v, o, r = find_rank8.run(8, 2, 16)
    assert r < 1e-9
    np.testing.assert_array_equal(u, U8)
    np.testing.assert_array_equal(v, V8)
    np.testing.assert_array_equal(o, O8)


def test_random_batch_is_the_reference_batch():
    got, want = random_batch(3, 17, 40, 62, 48), bench._make_batch(3, 17, 40, 62, 48)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    padded = random_batch(3, 17, 40, 62, 5, pad_to=9)
    assert padded["labels"].shape == (3, 9) and (padded["label_lengths"] == 5).all()


@pytest.mark.parametrize("local_world,cards,want", [
    (1, 1, ("cuda:0", None)), (4, 4, ("cuda:3", None)), (4, 1, ("cuda:0", "gloo")),
    (8, 2, ("cuda:1", "gloo")),
])
def test_join_world_shares_cards_over_gloo(monkeypatch, local_world, cards, want):
    """Under ``torch.distributed.run`` a rank takes ``cuda:LOCAL_RANK`` and
    NCCL (the backend left to ``initialize_multihost``); when the node's
    ranks outnumber its cards, card ``LOCAL_RANK % cards`` and gloo."""
    import qasr_torch.parallel.mesh as mesh

    local_rank = local_world - 1
    monkeypatch.setenv("RANK", str(local_rank))
    monkeypatch.setenv("WORLD_SIZE", str(local_world))
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    seen = {}

    def fake_init(*, device, backend):
        seen.update(device=device, backend=backend)
        return local_rank, local_world

    monkeypatch.setattr(mesh, "initialize_multihost", fake_init)
    assert cli._join_world("cuda") == (want[0], local_rank)
    assert (seen["device"], seen["backend"]) == want
    cli._join_world("cpu")
    assert seen == {"device": "cpu", "backend": None}
