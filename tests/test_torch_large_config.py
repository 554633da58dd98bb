"""Config 5 (``librispeech_large``) as the benchmark runs it
(``qbench/configs/librispeech_large.json``), on the CPU in float32 at small
widths that keep its layout: a thin conv, the pool, then a stacked run whose
width changes inside it (4, 4, 8, 8, 16, 16), three dense layers of one width
and 32 characters; ``train.remat_convs`` off and on.

The program against the benchmark's plain reference (``qbench/reference``):
the forward's logits, and three train steps with dropout against
``reference.train.train_steps`` in blocks of two rows, at the tolerances of
``qbench/tests/test_qbench_reference.py``. Then what remat adds to the
program: ``segment.recomputes`` counts one recompute a conv layer a step,
and under a profiler each recompute is a ``qasr.remat`` range in the
backward, a stacked layer's inside that layer's ``qasr.qconv`` range (so a
reader of ``qasr.qconv`` counts the recompute once). On the route the card
takes (``ChainLayerFn``, forced here through ``qconv_chain.takes_chain_fn``
on CPU tensors, where its wrappers take the plain versions), that node saves
only its input, the kernel and the slopes, so remat leaves the stacked layers
bare and checkpoints the packed layer alone, with the same gradients. Last,
the file keeps every width of the preset.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from qasr_torch.configs import get_config
from qasr_torch.models import build_model, qcnn
from qasr_torch.ops.kernels import qconv_chain
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import batch_to_device, forward_backward, train_step
from qasr_torch.utils.profiling import trace
from qbench.loops.train import program_config
from qbench.reference import model as ref_model
from qbench.reference import train as ref_train

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "qbench", "configs", "librispeech_large.json")
CONV = [4, 4, 8, 8, 16, 16]
REMAT = [False, True]


def _file() -> dict:
    with open(CONFIG) as f:
        return json.load(f)


def small(remat: bool) -> dict:
    conf = copy.deepcopy(_file())
    conf["model"].update(conv_features=CONV, dense_features=[16, 16, 16],
                         compute_dtype="float32")
    conf["train"].update(remat_convs=remat, warmup_steps=2)
    return conf


def batch(conf: dict, seed: int = 0, t: int = 24) -> dict:
    rng = np.random.default_rng(seed)
    lens = np.array([t, t - 5, t - 9], np.int32)
    feats = rng.standard_normal((3, t, conf["data"]["n_mels"], 4)).astype(np.float32)
    for i, n in enumerate(lens):
        feats[i, n:] = 0
    labels = rng.integers(1, conf["model"]["vocab"], size=(3, 6)).astype(np.int32)
    return {"features": feats, "feature_lengths": lens, "labels": labels,
            "label_lengths": np.array([6, 4, 3], np.int32), "real_rows": np.ones(3, bool)}


def _state(conf: dict, params: dict | None = None):
    return create_train_state(program_config(conf, 0), device="cpu", params=params)


def test_small_layout_keeps_a_width_change_inside_the_stacked_run():
    model = build_model(program_config(small(False), 0), device="cpu")
    run = [c for c, s in zip(CONV, model.stacked) if s]
    assert len(run) >= 3 and len(set(run)) > 1, model.stacked
    assert not model.stacked[0]


@pytest.mark.parametrize("remat", REMAT)
def test_forward_matches_the_reference(remat):
    conf = small(remat)
    params = ref_model.make_params(conf["model"], conf["data"]["n_mels"], 2, "cpu")
    model = build_model(program_config(conf, 0), device="cpu")
    model.load_state_dict(params)
    bt = batch(conf)
    x = torch.as_tensor(bt["features"])
    lens = torch.as_tensor(bt["feature_lengths"]).long()
    got = model(x, lengths=lens, plain=True, remat=remat)
    ref = ref_model.forward(params, conf["model"], x, lens, remat=remat)
    for i, n in enumerate(lens.tolist()):
        torch.testing.assert_close(got[i, :n].detach(), ref[i, :n].detach(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("remat", REMAT)
def test_train_steps_match_the_reference(remat):
    """Three updates with dropout 0.3: the losses, the first clipped
    gradients (as AdamW's first moment holds them) and the change over the
    three steps; the reference in blocks of two rows, as the cell's check
    runs in blocks."""
    conf = small(remat)
    params = ref_model.make_params(conf["model"], conf["data"]["n_mels"], 3, "cpu")
    batches = [batch(conf, seed=s) for s in range(3)]
    state = _state(conf, params)
    state.generator = torch.Generator().manual_seed(9)
    losses = []
    for i, bt in enumerate(batches):
        losses.append(float(train_step(state, bt)["loss"]))
        if i == 0:
            g0 = {k: state.optimizer.state[p]["exp_avg"] / 0.1
                  for k, p in state.model.named_parameters()}
    ref = ref_train.train_steps(params, conf["model"], conf["train"], batches,
                                torch.Generator().manual_seed(9), "cpu", rows_per_block=2,
                                remat=remat)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k, p in state.model.named_parameters():
        torch.testing.assert_close(g0[k], ref["first_grads"][k], rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(p.detach() - params[k], ref["change"][k], rtol=2e-2,
                                   atol=1e-7)


@pytest.mark.parametrize("remat", REMAT)
def test_recomputes_counted_once_a_conv_layer(remat):
    state = _state(small(remat))
    qcnn.segment.recomputes = 0
    train_step(state, batch(small(remat)))
    assert qcnn.segment.recomputes == (len(CONV) if remat else 0)
    qcnn.segment.recomputes = 0
    state.model.eval()
    with torch.no_grad():
        state.model(torch.as_tensor(batch(small(remat))["features"]), remat=remat)
    assert qcnn.segment.recomputes == 0


def _ranges(path: str) -> dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("qasr."):
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return {k: sorted(v) for k, v in out.items()}


def _inside(outer, inner) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_remat_ranges_lie_in_the_backward_inside_each_stacked_layer(tmp_path):
    """A remat step under a profiler that records the host: one
    ``qasr.remat`` range a conv layer, all inside ``qasr.backward``; each
    stacked layer's backward ``qasr.qconv`` range holds one of them, which
    holds the recompute's own ``qasr.qconv`` range; the thin layer's lies in
    no ``qasr.qconv`` range."""
    conf = small(True)
    state = _state(conf)
    train_step(state, batch(conf))
    with trace(str(tmp_path), force=True):
        train_step(state, batch(conf, seed=1))
    r = _ranges(os.path.join(tmp_path, "trace.json"))
    (backward,) = r["qasr.backward"]
    remat = r["qasr.remat"]
    assert len(remat) == len(CONV)
    assert all(_inside(backward, x) for x in remat)
    qconv_bwd = [q for q in r["qasr.qconv"] if _inside(backward, q)
                 and not any(_inside(x, q) for x in remat)]
    n_stacked = sum(state.model.stacked)
    assert len(qconv_bwd) == n_stacked
    for q in qconv_bwd:
        held = [x for x in remat if _inside(q, x)]
        assert len(held) == 1, (q, held)
        assert sum(_inside(held[0], p) for p in r["qasr.qconv"]) == 1
    outside = [x for x in remat if not any(_inside(q, x) for q in qconv_bwd)]
    assert len(outside) == len(CONV) - n_stacked


@pytest.mark.parametrize("scheme", ["fast8", "fast10"])
@pytest.mark.parametrize("prologue", [False, True])
def test_chain_layer_fn_saves_only_its_input_kernel_and_slopes(scheme, prologue):
    """What ``qcnn.quaternion_conv_tower`` leaves bare under remat rests on
    this: :class:`ChainLayerFn` saves ``x``, ``w`` and ``alpha`` themselves
    and nothing of its output's size. If the node ever saves more, a
    checkpoint around it frees something again and the rule in the tower
    has to go."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 4, 5, 9, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 3, 3, 8, 16)).astype(np.float32))
    bias = torch.zeros(64, requires_grad=True)
    alpha = torch.full((32,), 0.25, requires_grad=True) if prologue else None
    x.requires_grad_()
    w.requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        z = qconv_chain.ChainLayerFn.apply(x, w, bias, alpha, scheme)
    want = [x, w] + ([alpha] if prologue else [])
    assert len(saved) == len(want), [tuple(t.shape) for t in saved]
    for got, t in zip(saved, want):
        assert got is t
    assert not any(t.shape == z.shape for t in saved)
    z.square().sum().backward()
    assert x.grad is not None and w.grad is not None


def _force_route(monkeypatch, route: str) -> None:
    """``"chain_fn"``: every stacked layer off the plain route takes
    ``ChainLayerFn``, whatever the tensor's device, as a CUDA tensor does."""
    if route == "chain_fn":
        monkeypatch.setattr(qconv_chain, "takes_chain_fn", lambda x, plain=False: not plain)


def _grads(state, bt):
    state.model.zero_grad(set_to_none=True)
    loss = forward_backward(state, batch_to_device(bt, torch.device("cpu")))
    return loss, {k: p.grad.clone() for k, p in state.model.named_parameters()}


@pytest.mark.parametrize("route", ["chain_fn", "plain"])
def test_remat_leaves_chain_fn_layers_bare_with_the_same_gradients(route, monkeypatch):
    """A remat step from the same weights and batch: on the ``ChainLayerFn``
    route the packed layer is recomputed and the stacked layers run bare
    (``segment.bare``), on the plain route every conv layer is recomputed;
    either way the loss and gradients are those without remat, bit for
    bit."""
    _force_route(monkeypatch, route)
    bt = batch(small(False))
    params = _state(small(False)).model.state_dict()
    out = {}
    for remat in REMAT:
        state = _state(small(remat), params)
        n_stacked = sum(state.model.stacked)
        qcnn.segment.recomputes = qcnn.segment.bare = 0
        out[remat] = _grads(state, bt)
        bare = n_stacked if remat and route == "chain_fn" else 0
        assert qcnn.segment.bare == bare
        assert qcnn.segment.recomputes == (len(CONV) - bare if remat else 0)
    assert 0 < n_stacked < len(CONV)
    assert torch.equal(out[True][0], out[False][0])
    for k, g in out[True][1].items():
        assert torch.equal(g, out[False][1][k]), k


def test_chain_fn_route_traces_remat_ranges_for_the_packed_layers_only(tmp_path, monkeypatch):
    """On the ``ChainLayerFn`` route a remat step under a profiler holds one
    ``qasr.remat`` range a packed layer (config 5 has one, the thin conv
    with the pool), in the backward and in no ``qasr.qconv`` range; each
    stacked layer has one ``qasr.qconv`` range in the forward and one in
    the backward."""
    _force_route(monkeypatch, "chain_fn")
    conf = small(True)
    state = _state(conf)
    train_step(state, batch(conf))
    with trace(str(tmp_path), force=True):
        train_step(state, batch(conf, seed=1))
    r = _ranges(os.path.join(tmp_path, "trace.json"))
    (backward,) = r["qasr.backward"]
    n_stacked = sum(state.model.stacked)
    assert len(r["qasr.remat"]) == len(CONV) - n_stacked
    for x in r["qasr.remat"]:
        assert _inside(backward, x)
        assert not any(_inside(q, x) for q in r["qasr.qconv"])
    assert sum(_inside(backward, q) for q in r["qasr.qconv"]) == n_stacked
    assert len(r["qasr.qconv"]) == 2 * n_stacked


def test_file_keeps_every_width_of_the_preset():
    """Through the loop's ``program_config``: the preset's model group whole
    (no width cut), and only the keys the file lists under ``reduced`` or
    ``assumed`` differ from the preset (at run seed 0, the preset's)."""
    conf = _file()
    got, preset = program_config(conf, 0), get_config("librispeech_large")
    assert got.model.conv_features == preset.model.conv_features
    assert got.model.dense_features == preset.model.dense_features
    assert got.model.vocab == preset.model.vocab
    assert dataclasses.asdict(got.model) == dataclasses.asdict(preset.model)
    changed = {f"{g}.{k}" for g in ("data", "train", "decode")
               for k, v in dataclasses.asdict(getattr(got, g)).items()
               if v != dataclasses.asdict(getattr(preset, g))[k]}
    assert changed == {"data.cache_features", "train.remat_convs"}
    assert "data.cache_features" in conf["reduced"]
    assert any(a.startswith("train.remat_convs") for a in conf["assumed"])
    assert conf["mesh"]["model_axis"] == 1 != preset.mesh.model_axis
    assert "mesh.model_axis" in conf["reduced"]
