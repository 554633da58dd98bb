"""The plain reference against ``qasr_torch``'s plain path on the CPU, in
float32 at small widths: the two must compute the same functions."""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qbench.reference import ctc as ref_ctc
from qbench.reference import decode as ref_decode
from qbench.reference import frontend as ref_frontend
from qbench.reference import model as ref_model
from qbench.reference import train as ref_train

from conftest import ROOT

CONFIGS = ("timit_qcnn", "librispeech_qlstm")


def small(name: str) -> dict:
    with open(os.path.join(ROOT, "qbench", "configs", f"{name}.json")) as f:
        conf = json.load(f)
    conf = copy.deepcopy(conf)
    m = conf["model"]
    m["compute_dtype"] = "float32"
    if m["arch"] == "qlstm":
        m.update(conv_features=[8, 8], lstm_features=16, lstm_layers=2, dense_features=[16])
    else:
        m.update(conv_features=[8, 8, 8], dense_features=[16, 12])
    return conf


def program_model(conf: dict, params: dict, train: bool = False):
    from qasr_torch.models import build_model
    from qbench.loops.train import program_config

    model = build_model(program_config(conf, 0), device="cpu", train=train)
    model.load_state_dict(params)
    return model


def batch(conf: dict, b: int = 3, t: int = 24, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    lens = np.array([t, t - 5, t - 9][:b], np.int32)
    feats = rng.standard_normal((b, t, conf["data"]["n_mels"], 4)).astype(np.float32)
    for i, n in enumerate(lens):
        feats[i, n:] = 0
    labels = rng.integers(1, conf["model"]["vocab"], size=(b, 6)).astype(np.int32)
    return {"features": feats, "feature_lengths": lens, "labels": labels,
            "label_lengths": np.array([6, 4, 3][:b], np.int32), "real_rows": np.ones(b, bool)}


def test_expand_is_the_hamilton_product():
    from qasr_torch.ops.quaternion import hamilton_expand

    w = torch.randn(4, 3, 3, 5, 7, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ref_model.expand(w), hamilton_expand(w))


@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_match_the_program(name):
    conf = small(name)
    params = ref_model.make_params(conf["model"], conf["data"]["n_mels"], 1, "cpu")
    model = program_model(conf, params)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in params.items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_program(name):
    conf = small(name)
    params = ref_model.make_params(conf["model"], conf["data"]["n_mels"], 2, "cpu")
    model = program_model(conf, params)
    bt = batch(conf)
    x = torch.as_tensor(bt["features"])
    lens = torch.as_tensor(bt["feature_lengths"]).long()
    with torch.no_grad():
        got = model(x, lengths=lens, plain=True)
        ref = ref_model.forward(params, conf["model"], x, lens)
    for i, n in enumerate(lens.tolist()):
        torch.testing.assert_close(got[i, :n], ref[i, :n], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_steps_match_the_program(name):
    """Three updates with dropout: losses, the first clipped gradients (as
    AdamW's first moment holds them) and the parameters after."""
    from qasr_torch.train.state import create_train_state
    from qasr_torch.train.step import train_step
    from qbench.loops.train import program_config

    conf = small(name)
    conf["train"]["warmup_steps"] = 2  # the later steps move the weights visibly
    params = ref_model.make_params(conf["model"], conf["data"]["n_mels"], 3, "cpu")
    batches = [batch(conf, seed=s) for s in range(3)]
    state = create_train_state(program_config(conf, 0), device="cpu", params=params)
    state.generator = torch.Generator().manual_seed(9)
    losses = []
    for i, bt in enumerate(batches):
        losses.append(float(train_step(state, bt)["loss"]))
        if i == 0:
            g0 = {k: state.optimizer.state[p]["exp_avg"] / 0.1
                  for k, p in state.model.named_parameters()}
    ref = ref_train.train_steps(params, conf["model"], conf["train"], batches,
                                torch.Generator().manual_seed(9), "cpu", rows_per_block=2)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k, p in state.model.named_parameters():
        torch.testing.assert_close(g0[k], ref["first_grads"][k], rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(p.detach() - params[k], ref["change"][k], rtol=2e-2,
                                   atol=1e-7)


def test_learning_rate_matches_the_program():
    from qasr_torch.train.state import warmup_cosine_schedule
    from qbench.loops.train import program_config

    conf = small("timit_qcnn")
    lr = warmup_cosine_schedule(program_config(conf, 0))
    for step in (0, 1, 250, 499, 500, 501, 20000, 39999, 40000, 50000):
        assert ref_train.learning_rate(conf["train"], step) == pytest.approx(lr(step), rel=1e-12)


def test_ctc_matches_the_library():
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(3, 30, 9, generator=g, requires_grad=True)
    labels = torch.tensor([[1, 2, 2, 3, 0], [4, 4, 4, 0, 0], [5, 0, 0, 0, 0]])
    frames = torch.tensor([30, 21, 7])
    llens = torch.tensor([4, 3, 1])
    ref = ref_ctc.ctc_nll(logits, labels, frames, llens)
    lib = F.ctc_loss(torch.log_softmax(logits, -1).transpose(0, 1), labels, frames, llens,
                     reduction="none")
    torch.testing.assert_close(ref, lib, rtol=1e-5, atol=1e-4)
    (g1,) = torch.autograd.grad(ref.sum(), logits)
    (g2,) = torch.autograd.grad(lib.sum(), logits)
    torch.testing.assert_close(g1, g2, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seconds", [0.3, 2.71])
def test_frontend_matches_the_program(seconds):
    from qasr_torch.features.frontend import FrontendConfig, featurize_waveform

    rng = np.random.default_rng(5)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    wav = (0.1 * np.sin(2 * np.pi * 440 * t) + 0.01 * rng.standard_normal(n)).astype(np.float32)
    got = featurize_waveform(wav, FrontendConfig(), device="cpu")
    ref = ref_frontend.featurize(wav)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-3)


def test_greedy_decode_matches_the_program():
    from qasr_torch.data.librispeech import ids_to_text
    from qasr_torch.data.timit import ID_TO_PHONE
    from qasr_torch.ops.ctc import ctc_greedy_decode

    g = torch.Generator().manual_seed(6)
    logits = torch.randn(4, 40, 62, generator=g)
    logits[:, ::3, 0] += 4  # blanks between repeats
    lens = torch.tensor([40, 33, 1, 17])
    seq, n = ctc_greedy_decode(logits, lens)
    for i, t in enumerate(lens.tolist()):
        ids = ref_decode.best_path(logits[i, :t].argmax(-1).tolist())
        assert ids == seq[i, : n[i]].tolist()
        assert ref_decode.to_symbols(ids, "timit") == [ID_TO_PHONE[j] for j in ids]
        assert ref_decode.to_symbols([j % 32 for j in ids], "librispeech") == \
            ids_to_text([j % 32 for j in ids])
