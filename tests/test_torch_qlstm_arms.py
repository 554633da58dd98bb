"""The rest of the QLSTM family against the JAX package: the block recurrence
(``QBiLSTM(recurrent="block")``, ``op_variant`` ``block`` and ``fast8``),
the unidirectional ``QLSTMLayer`` and ``QLSTMEncoder(bidirectional=False)``,
``build_model``'s qlstm table, the bridge, the reverse layer's length mask
(a deliberate divergence) and a reduced config-4 training run step by step.

Inputs come from numpy with a seed; weights are drawn by the JAX package and
bridged into the port. Each JAX reference is one ``jax.jit`` computation,
shared by the cases that read it.

Tolerances. f32: 1e-5 for a layer (the products sum in another order: the
measured worst is ~1e-7), 1e-4 for whole encoders and their gradients, as
tests/test_torch_qlstm.py holds them. bf16 (the layers on the block input
projection, so that only the recurrences differ): both packages carry h and
c in bf16, rounded every step, but XLA keeps each step's elementwise chain
(the gates, ``f*c + i*g``) in f32 between its roundings (excess precision)
where PyTorch rounds every op, so the outputs differ by a few bf16 ulps
(2^-8 at |h| < 1), damped by the forget gates: rel-norm 1e-2, largest
difference 3e-2 (measured: 5e-3 and 5.9e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.configs import get_config as jget_config
from qasr.data.batching import BatchStream as JBatchStream
from qasr.data.pipeline import LibriFeaturePipeline as JLibriFeaturePipeline
from qasr.models import qlstm as jqlstm
from qasr.train.state import build_model as jbuild_model
from qasr.train.state import create_train_state as jcreate_train_state
from qasr.train.step import make_train_step
from qasr_torch.bridge import params_from_jax, params_to_jax
from qasr_torch.configs import get_config
from qasr_torch.infer import Transcriber
from qasr_torch.models import build_model, qlstm_routing
from qasr_torch.models.qlstm import QBiLSTM, QLSTMLayer
from qasr_torch.tools.make_mini_librispeech import write_corpus
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import batch_to_device, loss_fn, train_step
from tests.test_torch_qlstm import _random_biases

torch.set_num_threads(1)
TOL_LAYER = dict(rtol=1e-5, atol=1e-5)
TOL_ENC = dict(rtol=1e-4, atol=1e-4)
BF16_REL_NORM, BF16_MAX = 1e-2, 3e-2
_DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}

B, T, CIN, HID = 3, 12, 8, 16
LENGTHS = np.array([12, 7, 3], np.int32)

CFG = get_config("librispeech_qlstm").override(**{
    "model.conv_features": (8, 8, 16, 16),
    "model.lstm_features": 16,
    "model.lstm_layers": 2,
    "model.vocab": 12,
    "model.compute_dtype": "float32",
    "model.dropout_rate": 0.0,
    "data.n_mels": 8,
    "data.bucket_sizes": (64, 128),
    "decode.beam_width": 4,
})


def _x(seed=0):
    return (np.random.default_rng(seed).standard_normal((B, T, 4 * CIN)) * 0.5).astype(np.float32)


def _close(got: torch.Tensor, want, dtype: str, tol=TOL_LAYER) -> None:
    got, want = got.float().detach().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **tol)
    else:
        assert np.linalg.norm(got - want) <= BF16_REL_NORM * np.linalg.norm(want)
        assert np.abs(got - want).max() <= BF16_MAX


@functools.lru_cache(maxsize=None)
def _jax_layer(kind: str, recurrent: str, reverse: bool, dtype: str):
    """A JAX layer (``QLSTMLayer`` or ``QBiLSTM``) on the block input
    projection, its params (random biases) and its jitted apply."""
    jdt = _DT[dtype][1]
    if kind == "uni":
        ref = jqlstm.QLSTMLayer(hidden=HID, reverse=reverse, dtype=jdt, input_proj="block",
                                recurrent=recurrent)
    else:
        ref = jqlstm.QBiLSTM(hidden=HID, dtype=jdt, input_proj="block", recurrent=recurrent)
    params = jax.jit(ref.init)(jax.random.PRNGKey(1), jnp.asarray(_x()))["params"]
    params = _random_biases(params, seed=2)
    return ref, params, jax.jit(lambda p, xx, ll: ref.apply({"params": p}, xx, ll))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_lengths", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("recurrent", ["block", "fast8"])
def test_qlstm_layer_matches_jax(recurrent, reverse, use_lengths, dtype):
    """``QLSTMLayer`` forward and reverse, on each recurrence, against the
    JAX layer. The forward layer takes ragged lengths; the reverse one every
    length T (with ragged lengths the two packages differ on purpose:
    ``test_reverse_layer_masks_by_frame``)."""
    ref, params, apply = _jax_layer("uni", recurrent, reverse, dtype)
    lengths = np.full(B, T, np.int32) if reverse else LENGTHS
    x = _x()
    want = apply(params, jnp.asarray(x), jnp.asarray(lengths) if use_lengths else None)
    port = QLSTMLayer(CIN, HID, reverse=reverse, dtype=_DT[dtype][0], input_proj="block",
                      recurrent=recurrent, device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(lengths) if use_lengths else None)
    assert got.dtype == _DT[dtype][0]
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_lengths", [False, True])
def test_qbilstm_block_matches_jax(use_lengths, dtype):
    """``QBiLSTM(recurrent="block")``: both directions' block recurrence in
    one loop, ragged lengths."""
    _, params, apply = _jax_layer("bi", "block", False, dtype)
    x = _x(seed=3)
    want = apply(params, jnp.asarray(x), jnp.asarray(LENGTHS) if use_lengths else None)
    port = QBiLSTM(CIN, HID, dtype=_DT[dtype][0], input_proj="block", recurrent="block",
                   device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(LENGTHS) if use_lengths else None)
    _close(got, want, dtype)


@pytest.mark.parametrize("recurrent", ["block", "fast8"])
def test_reverse_layer_masks_by_frame(recurrent):
    """A reverse ``QLSTMLayer`` given ``lengths`` equals the layer run on
    each utterance cut to its length: it freezes on the padding, a frame
    being active where ``frame < length`` (as ``QBiLSTM``'s backward
    direction). The JAX layer reverses its frame index and scans with
    ``reverse=True`` as well, so it runs over the padding and freezes on
    the first frames: its masked output is off the truncated one by ~0.5
    (hidden 16, T 12), while its forward layer agrees. The port keeps the
    correct mask (ROADMAP.md Queue 3, "Deliberate divergences")."""
    _, params, apply = _jax_layer("uni", recurrent, True, "float32")
    _, fparams, fapply = _jax_layer("uni", recurrent, False, "float32")
    x = _x(seed=4)
    port = QLSTMLayer(CIN, HID, reverse=True, input_proj="block", recurrent=recurrent,
                      device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        masked = port(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    jmasked = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(LENGTHS)))
    jfwd = np.asarray(fapply(fparams, jnp.asarray(x), jnp.asarray(LENGTHS)))
    jax_off = 0.0
    for i, n in enumerate(LENGTHS):
        with torch.no_grad():
            alone = port(torch.from_numpy(x[i:i + 1, :n]))
        torch.testing.assert_close(masked[i:i + 1, :n], alone, rtol=1e-6, atol=1e-6)
        jalone = np.asarray(apply(params, jnp.asarray(x[i:i + 1, :n]), None))
        jax_off = max(jax_off, np.abs(jmasked[i, :n] - jalone[0]).max())
        jfalone = np.asarray(fapply(fparams, jnp.asarray(x[i:i + 1, :n]), None))
        np.testing.assert_allclose(jfwd[i, :n], jfalone[0], **TOL_LAYER)
    assert jax_off > 0.1


def test_qlstm_routing_table():
    """``build_model``'s qlstm table: each ``op_variant``, bidirectional and
    not, on the card (kernel D where it applies) and on the CPU; a
    unidirectional ``pallas8`` raises ``ValueError``, as the JAX layer does.
    Every layer takes the routing it says, in eval and train mode."""
    base = get_config("librispeech_qlstm")
    table = {  # op_variant -> bidirectional on the card, unidirectional
        "block": (("block", "block"), ("block", "block")),
        "fast8": (("fast8", "block"), ("fast8", "block")),
        "auto": (("auto", "pallas8"), ("auto", "fast8")),
        "fast8_recurrent": (("auto", "pallas8"), ("auto", "fast8")),
        "pallas8": (("pallas8", "pallas8"), ("pallas8", "pallas8")),
    }
    for variant, (bi, uni) in table.items():
        m = base.override(**{"model.op_variant": variant}).model
        assert qlstm_routing(m, "cuda") == bi
        assert qlstm_routing(m, "cpu") == (bi if bi[1] == "block" else (bi[0], "fast8"))
        mu = base.override(**{"model.op_variant": variant, "model.bidirectional": False}).model
        assert qlstm_routing(mu, "cuda") == qlstm_routing(mu, "cpu") == uni
    for train in (False, True):
        for variant in table:
            for bidir in (True, False):
                cfg = CFG.override(**{"model.op_variant": variant, "model.bidirectional": bidir})
                if variant == "pallas8" and not bidir:
                    with pytest.raises(ValueError, match="bidirectional-only"):
                        build_model(cfg, device="cpu", train=train)
                    continue
                model = build_model(cfg, device="cpu", train=train)
                want = qlstm_routing(cfg.model, "cpu")
                assert model.training == train and model.bidirectional == bidir
                for i in range(model.lstm_layers):
                    layer = model.lstm(i)
                    assert type(layer) is (QBiLSTM if bidir else QLSTMLayer)
                    assert (layer.input_proj, layer.recurrent) == want
                names = {k.split(".")[0] for k in model.state_dict()}
                assert {"qbilstm_0", "qbilstm_1"} <= names if bidir else \
                    {"qlstm_0", "qlstm_1"} <= names


@functools.lru_cache(maxsize=None)
def _jax_encoder(variant: str, bidirectional: bool):
    """The JAX encoder of CFG at ``variant``, its params (random biases) and
    its logits and loss gradients on one ragged batch, one jit each."""
    over = {"model.op_variant": variant, "model.bidirectional": bidirectional}
    jcfg = jget_config("librispeech_qlstm").override(**{**_CFG_OVER, **over})
    model = jbuild_model(jcfg)
    x, lengths, batch = _enc_batch()
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _random_biases(jax.tree.map(np.asarray, params), seed=5)
    logits = jax.jit(lambda p, xx, ll: model.apply({"params": p}, xx, train=False, lengths=ll))(
        params, jnp.asarray(x), jnp.asarray(lengths))

    from qasr.ops.ctc import ctc_loss as jctc_loss

    def jloss(p):
        out = model.apply({"params": p}, jnp.asarray(x), train=False, lengths=jnp.asarray(lengths))
        losses = jctc_loss(out, jnp.asarray(batch["labels"]), jnp.asarray(lengths),
                           jnp.asarray(batch["label_lengths"]))
        return losses.sum() / batch["label_lengths"].sum()

    grads = jax.jit(jax.grad(jloss))(params)
    return params, np.asarray(logits), params_from_jax(jax.tree.map(np.asarray, grads))


_CFG_OVER = {
    "model.conv_features": (8, 8, 16, 16), "model.lstm_features": 16, "model.lstm_layers": 2,
    "model.vocab": 12, "model.compute_dtype": "float32", "model.dropout_rate": 0.0,
    "data.n_mels": 8,
}


def _enc_batch():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 29, 8, 4)).astype(np.float32)
    lengths = np.array([29, 17, 5], np.int32)
    x[np.arange(29)[None, :] >= lengths[:, None]] = 0.0
    batch = {"features": x, "feature_lengths": lengths,
             "labels": rng.integers(1, 12, size=(3, 4)).astype(np.int32),
             "label_lengths": np.array([4, 3, 2], np.int32), "real_rows": np.ones(3, bool)}
    return x, lengths, batch


@pytest.mark.parametrize("variant,bidirectional", [("block", True), ("fast8", True),
                                                   ("auto", False), ("block", False)])
def test_encoder_arms_match_jax(variant, bidirectional):
    """The whole encoder on each new arm against JAX's ``build_model`` with
    the same config, f32, ragged lengths: the logits and every parameter's
    loss gradient (the port's routing on the CPU: the block product or
    kernel B's plain version in, the block or fast8 recurrence)."""
    params, want, want_g = _jax_encoder(variant, bidirectional)
    cfg = CFG.override(**{"model.op_variant": variant, "model.bidirectional": bidirectional})
    port = build_model(cfg, device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    x, lengths, batch = _enc_batch()
    tb = batch_to_device(batch, torch.device("cpu"))
    logits = port(tb["features"], lengths=tb["feature_lengths"])
    np.testing.assert_allclose(logits.detach().numpy(), want, **TOL_ENC)
    loss_fn(cfg, logits, tb).backward()
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), err_msg=k, **TOL_ENC)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_bridge_round_trip(bidirectional):
    """JAX -> port -> JAX: a ``QLSTMLayer`` tree and a whole encoder's,
    every leaf the same bits and the same names."""
    _, params, _ = _jax_layer("uni", "block", False, "float32")
    port = QLSTMLayer(CIN, HID, input_proj="block", recurrent="block", device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    assert set(port.state_dict()) == {"cell.wx", "cell.wh", "cell.bias"}
    back = params_to_jax(port.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, params))
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params))
    tree, _, _ = _jax_encoder("block", bidirectional)
    enc = build_model(CFG.override(**{"model.bidirectional": bidirectional}), device="cpu")
    enc.load_state_dict(params_from_jax(tree), strict=True)
    back = params_to_jax(enc.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_new_arms_serve_and_train():
    """Each new quaternion arm serves through ``Transcriber`` (greedy) and
    takes train steps that lower the loss on one batch; the CPU runs no
    kernel."""
    from qasr_torch.ops.kernels.qgemm8 import qgemm8_cl

    wavs = [(0.1 * np.random.default_rng(7).standard_normal(n)).astype(np.float32)
            for n in (6000, 3500)]
    _, _, batch = _enc_batch()
    before = qgemm8_cl.launches
    for over in ({"model.op_variant": "block"}, {"model.op_variant": "fast8"},
                 {"model.bidirectional": False}):
        cfg = CFG.override(**{**over, "train.warmup_steps": 1, "train.learning_rate": 1e-2})
        state = create_train_state(cfg, device="cpu")
        losses = [train_step(state, batch)["loss"].item() for _ in range(4)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], (over, losses)
        out = Transcriber(cfg=cfg, params=state.model.state_dict(), device="cpu").transcribe_batch(
            wavs)
        assert len(out) == 2, over
    assert qgemm8_cl.launches == before


@pytest.fixture(scope="module")
def mini_libri(tmp_path_factory):
    root = tmp_path_factory.mktemp("libri")
    write_corpus(str(root), speakers=2, utts_per_speaker=4, dev_speakers=1, seed=0)
    return str(root)


# Queue 3 item 3's reduced config 4: two narrow convs, one biQLSTM of H 16,
# B 4, f32, dropout 0, the preset's rate after a 4-step warmup, 20 steps;
# buckets of 128 and 256 frames (mini-LibriSpeech's utterances take 74-198)
TRAJ_OVER = {
    "model.conv_features": (8, 16), "model.lstm_features": 16, "model.lstm_layers": 1,
    "model.dense_features": (16,), "model.compute_dtype": "float32", "model.dropout_rate": 0.0,
    "data.batch_size": 4, "data.bucket_sizes": (128, 256), "train.num_steps": 20,
    "train.warmup_steps": 4, "train.learning_rate": 1e-3,
}


def test_config4_reduced_trajectory_matches_jax(mini_libri, tmp_path):
    """20 train steps of a reduced config 4 on mini-LibriSpeech, the JAX
    package's ``make_train_step`` and the port's ``train_step`` from bridged
    identical weights on the same batches (the JAX pipeline's features and
    batch stream): the loss held step by step at 1e-4 relative, the order
    f32 gives. The two runs track, so a gap between the packages' CERs on
    the card is a difference between the runs, not a fault of the port's
    arithmetic."""
    over = {**TRAJ_OVER, "data.data_dir": mini_libri}
    jcfg = jget_config("librispeech_qlstm").override(**over)
    tcfg = get_config("librispeech_qlstm").override(**over)
    data = JLibriFeaturePipeline(jcfg, "train-clean-100", cache_dir=str(tmp_path / "cache"))
    stream = JBatchStream(data, jcfg.data, seed=0)
    batches = [next(stream) for _ in range(jcfg.train.num_steps)]
    assert any(b["feature_lengths"].min() < b["features"].shape[1] for b in batches)
    jstate = jax.jit(lambda f: jcreate_train_state(jcfg, jax.random.PRNGKey(0), f))(
        batches[0]["features"])
    state = create_train_state(
        tcfg, device="cpu", params=params_from_jax(jax.tree.map(np.array, jstate.params)))
    assert state.model.recurrent == "fast8"
    jstep = make_train_step(jcfg)
    jl, tl = [], []
    for batch in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jl.append(float(jm["loss"]))
        tl.append(train_step(state, batch)["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
