"""The port's own spans (``qasr_torch.utils.profiling``): one name list,
``span`` and ``traced`` on the profiler's clock, at each layer of the train
step, forward and backward; nothing added when no profiler records; and the
benchmark's readers of them (``qbench/metrics/*_ms_per_audio_s.train.py``)
and of the names its older readers match (``chain_layer``,
``qlstm_scan_fast8``, ``ChainLayerFn``, ``QLstmScanFn``).

The profiler records host activity alone here (CPU), where the backward
runs on the calling thread.
"""

import importlib
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qasr_torch.configs import get_config
from qasr_torch.data.synthetic import random_batch
from qasr_torch.models import layers, qlstm
from qasr_torch.ops.kernels.qconv_chain import ChainLayerFn
from qasr_torch.ops.kernels.qlstm_scan import QLstmScanFn
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import train_step
from qasr_torch.utils import profiling
from qbench.trace import TraceSummary

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = os.path.join(ROOT, "qbench", "metrics")
#: the new readers and the spans each reads
READERS = {
    "qconv_ms_per_audio_s.train": "qasr.qconv",
    "bilstm_ms_per_audio_s.train": "qasr.bilstm",
    "dense_ms_per_audio_s.train": "qasr.dense",
    "ctc_ms_per_audio_s.train": "qasr.ctc",
    "optimizer_ms_per_audio_s.train": "qasr.optimizer",
    "conv_dw_ms_per_audio_s.train": "qasr.conv_dw",
}
#: spans with a backward of their own
LAYER_SPANS = ("qasr.ctc", "qasr.qconv", "qasr.dense", "qasr.bilstm", "qasr.qlstm_scan")
STEP_SPANS = ("qasr.train_step", "qasr.h2d", "qasr.forward", "qasr.backward",
              "qasr.optimizer")

# a tiny QCNN: a thin layer, the pool, three stacked layers, two dense
QCNN = {"model.conv_features": (8, 8, 8, 8), "model.dense_features": (8, 8),
        "model.vocab": 12, "model.dropout_rate": 0.3, "model.compute_dtype": "float32",
        "data.n_mels": 8, "train.warmup_steps": 1, "train.grad_clip": 1.0}
# a tiny QCNN-biQLSTM: the tower's thin and stacked layers, two biQLSTMs
QLSTM = {"model.conv_features": (8, 8, 8), "model.lstm_features": 16,
         "model.lstm_layers": 2, "model.dense_features": (8,), "model.vocab": 12,
         "model.dropout_rate": 0.3, "model.compute_dtype": "float32", "data.n_mels": 8,
         "data.dataset": "synthetic", "train.warmup_steps": 1, "train.grad_clip": 1.0}
ARCHS = {
    "qcnn": ("timit_qcnn", QCNN, ("qasr.ctc", "qasr.qconv", "qasr.dense")),
    "qlstm": ("librispeech_qlstm", QLSTM, LAYER_SPANS),
}


def _state(arch):
    preset, over, _ = ARCHS[arch]
    state = create_train_state(get_config(preset).override(**over), device="cpu")
    for m in state.model.modules():
        if isinstance(m, qlstm.QBiLSTM):
            m.recurrent = "pallas8"  # QLstmScanFn's plain path on the CPU
    return state


def _batch(seed=0):
    b = random_batch(3, 24, 8, 12, 5, seed=seed)
    b["feature_lengths"] = np.array([24, 19, 13], np.int32)
    return b


def _load_reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name.replace('.', '_')}", os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _graph_names(t):
    """Names of every autograd node reachable from ``t``."""
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return names


def _n_stacked(model):
    return sum(model.stacked)


def test_span_names_unique_and_substring_free():
    spans = profiling.SPANS
    assert len(set(spans)) == len(spans)
    for a in spans:
        assert a.startswith("qasr.")
        for b in spans:
            assert a == b or a not in b, (a, b)


@pytest.mark.parametrize("scheme,prologue", [("fast8", True), ("fast8", False), ("fast10", True)])
def test_chain_layer_fn_opens_conv_dw_once_per_backward(scheme, prologue):
    """:class:`ChainLayerFn`'s backward computes dW and db under one
    ``qasr.conv_dw`` range (a name of ``SPANS``, and not a part of
    ``qasr.qconv``, inside whose backward range it runs in a model); its
    forward opens none."""
    assert "qasr.conv_dw" in profiling.SPANS
    rng = np.random.default_rng(11)
    args = [torch.from_numpy(a) for a in (
        rng.standard_normal((2, 4, 3, 7, 8)).astype(np.float32),
        (0.2 * rng.standard_normal((4, 3, 3, 8, 8))).astype(np.float32),
        np.zeros(32, np.float32), (0.25 * rng.standard_normal(32)).astype(np.float32))]
    ts = [a.requires_grad_() for a in args]
    alpha = ts[3] if prologue else None
    ChainLayerFn.apply(ts[0], ts[1], ts[2], alpha, scheme).sum().backward()
    with profile(activities=[ProfilerActivity.CPU]) as fwd:
        z = ChainLayerFn.apply(ts[0], ts[1], ts[2], alpha, scheme)
    assert not [e for e in fwd.events() if e.name.startswith("qasr.")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        z.sum().backward()
    spans = [e for e in prof.events() if e.name == "qasr.conv_dw"]
    nodes = [e for e in prof.events() if e.name == "ChainLayerFnBackward"]
    assert len(spans) == len(nodes) == 1
    assert _contains(nodes[0], spans[0])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_a_span(name):
    """Each new reader names one span of ``SPANS``, opens no range of its own,
    and reads ``1e3 x device / audio`` off a summary; None where its span did
    not run or there is no trace."""
    mod = _load_reader(name)
    assert mod.OPS == (READERS[name],)
    assert set(mod.OPS) <= set(profiling.SPANS)
    assert not getattr(mod, "RANGES", ())
    items = [{"audio_s": 10.0}, {"audio_s": 30.0}]
    summary = TraceSummary(window_s=1.0, busy_s=0.5, ops={READERS[name]: 0.02})
    ctx = SimpleNamespace(trace=summary, profiled={"items": items})
    assert mod.read(ctx) == pytest.approx(1e3 * 0.02 / 40.0, rel=1e-12)
    ctx.trace = TraceSummary(window_s=1.0, busy_s=0.5,
                             ops={k: 0.01 for k in profiling.SPANS if k != READERS[name]})
    assert mod.read(ctx) is None
    ctx.trace = None
    assert mod.read(ctx) is None


def test_span_is_free_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("qasr.qconv") is profiling.span("qasr.dense")
    assert isinstance(profiling.span("qasr.qconv"), type(profiling._NULL))
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span("qasr.qconv"), profiling._RecordFunctionFast)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_span_nodes_only_under_a_profiler(arch, monkeypatch):
    """The backward ranges are hooks on the layers' own nodes, set only under
    a profiler: with one or without, the graph holds the same nodes; with
    none no bracket is made, under one each traced call's bracket opens and
    closes once in the backward."""
    made = []

    class Counting(profiling._Bracket):
        __slots__ = ("opened", "closed")

        def __init__(self, name):
            super().__init__(name)
            self.opened = self.closed = 0
            made.append(self)

        def open(self, grads):
            self.opened += 1
            super().open(grads)

        def close(self, grad):
            self.closed += 1
            super().close(grad)

    monkeypatch.setattr(profiling, "_Bracket", Counting)
    state = _state(arch)
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    model = state.model

    def logits():
        return model(batch["features"], lengths=batch["feature_lengths"].long(),
                     generator=torch.Generator().manual_seed(0))

    out = logits()
    names = _graph_names(out)
    out.sum().backward()
    assert not made
    with profile(activities=[ProfilerActivity.CPU]):
        out = logits()
        assert _graph_names(out) == names
        out.sum().backward()
    # stacked convs, the dense head, and per biQLSTM the layer and its scan
    calls = _n_stacked(model) + 1 + 2 * getattr(model, "lstm_layers", 0)
    assert len(made) == calls
    assert all(b.opened == b.closed == 1 and b.rf is None for b in made)


def _contains(outer, inner):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_records_every_span(arch):
    """One train step under the profiler: every step span once, each layer
    span in the forward and in the backward as often as the layer runs, the
    recurrence's backward node inside both its spans' backward ranges."""
    _, _, layer_spans = ARCHS[arch]
    state = _state(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, _batch())
    events = [e for e in prof.events() if e.name.startswith("qasr.")]
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    assert set(by_name) <= set(profiling.SPANS)
    for name in STEP_SPANS:
        assert len(by_name.get(name, ())) == 1, name
    assert set(by_name) == set(STEP_SPANS) | set(layer_spans)
    backward = by_name["qasr.backward"][0]
    runs = {"qasr.ctc": 1, "qasr.dense": 1, "qasr.qconv": _n_stacked(state.model),
            "qasr.bilstm": 2, "qasr.qlstm_scan": 2}
    for name in layer_spans:
        bwd = [e for e in by_name[name] if _contains(backward, e)]
        fwd = [e for e in by_name[name] if e.time_range.end <= backward.time_range.start]
        assert len(fwd) == len(bwd) == runs[name], (name, len(fwd), len(bwd))
    if arch == "qlstm":
        nodes = [e for e in prof.events() if e.name == "QLstmScanFnBackward"]
        assert len(nodes) == 2
        for node in nodes:
            for name in ("qasr.qlstm_scan", "qasr.bilstm"):
                assert any(_contains(e, node) for e in by_name[name]
                           if _contains(backward, e)), name


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spans_leave_the_step_bit_equal(arch):
    """Two steps from the same weights and dropout seed, with and without a
    profiler recording: the same losses, gradients and parameters, bit for
    bit."""
    runs = []
    for traced in (False, True):
        state = _state(arch)
        out = []
        for seed in (0, 1):
            if traced:
                with profile(activities=[ProfilerActivity.CPU]):
                    m = train_step(state, _batch(seed))
            else:
                m = train_step(state, _batch(seed))
            grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
            out.append((m["loss"].clone(), m["grad_norm"].clone(), grads))
        params = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        runs.append((out, params))
    (a, pa), (b, pb) = runs
    for (la, na, ga), (lb, nb, gb) in zip(a, b):
        assert torch.equal(la, lb) and torch.equal(na, nb)
        assert ga.keys() == gb.keys()
        for k in ga:
            assert torch.equal(ga[k], gb[k]), k
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_benchmark_patch_points_still_called(arch, monkeypatch):
    """The older readers' ranges wrap ``models.layers.chain_layer`` and
    ``models.qlstm.qlstm_scan_fast8`` by module attribute, and match the
    backward by the autograd node names of ``ChainLayerFn`` and
    ``QLstmScanFn``: the model still calls through those attributes, once a
    stacked layer and once a biQLSTM, under the spans."""
    assert ChainLayerFn.__name__ == "ChainLayerFn"
    assert QLstmScanFn.__name__ == "QLstmScanFn"
    for reader in ("qconv_roofline_pct.train", "qlstm_roofline_pct.train"):
        for modname, attr, _ in _load_reader(reader).RANGES:
            assert callable(getattr(importlib.import_module(modname), attr))
    calls = {"chain": 0, "scan": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(layers, "chain_layer", counting("chain", layers.chain_layer))
    monkeypatch.setattr(qlstm, "qlstm_scan_fast8", counting("scan", qlstm.qlstm_scan_fast8))
    state = _state(arch)
    with profile(activities=[ProfilerActivity.CPU]):
        train_step(state, _batch())
    assert calls["chain"] == _n_stacked(state.model) > 0
    assert calls["scan"] == getattr(state.model, "lstm_layers", 0)
