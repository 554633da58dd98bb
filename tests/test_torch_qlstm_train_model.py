"""The qasr_torch QLSTM training slice as a whole (config 4's train step)
against the JAX package: the encoder's loss gradients, three train steps,
the padded batch, dropout and ``train()`` (the recurrence and one layer:
tests/test_torch_qlstm_train.py).

A small qlstm (conv (8, 8, 16, 16), two bidirectional layers of H = 16,
vocab 12, 8 mels, f32) is initialised by the JAX package from a seed and
bridged into the port; both take the same ragged synthetic batches. On the
CPU the port runs kernels D's, E's and B's plain versions; the JAX side
(the fast8 recurrence, as JAX routes it off the TPU) runs each reference as
one ``jax.jit`` computation, computed once for every case that reads it.

Tolerances, f32: 1e-4 for the encoder's parameter gradients (a few f32
layers deep); the train step's loss and grad norm 1e-5, as
tests/test_torch_train.py holds them, and its params atol 5e-5 (an Adam
update moves a weight by up to lr = 3e-3 whatever its gradient's size, so
where a gradient is near zero the ~1e-6 relative sum-order difference of the
recurrences' f32 gradients moves the update; measured worst 1.25e-5 after
three steps).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.configs import get_config as jget_config
from qasr.data.batching import BatchStream as JBatchStream
from qasr.data.synthetic import SyntheticDataset as JSyntheticDataset
from qasr.ops.ctc import ctc_loss as jctc_loss
from qasr.train.state import build_model as jbuild_model
from qasr.train.state import create_train_state as jcreate_train_state
from qasr.train.step import make_eval_step, make_train_step
from qasr_torch.bridge import params_from_jax
from qasr_torch.configs import get_config
from qasr_torch.infer import Transcriber
from qasr_torch.models import build_model
from qasr_torch.models.qlstm import QLSTMEncoder
from qasr_torch.train.loop import train
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import batch_to_device, eval_step, loss_fn, train_step
from tests.test_torch_qlstm_train import TOL_GRAD, _port_grads, _random_biases, _t

torch.set_num_threads(1)

# The smallest config-4 model that pins the slice: the tower's thin and
# stacked layers (16 channels, a multiple of 8), two bidirectional layers
# (one feeds the next), H = 16, batches of 64 frames with ragged lengths.
OVERRIDES = {
    "model.conv_features": (8, 8, 16, 16),
    "model.lstm_features": 16,
    "model.lstm_layers": 2,
    "model.vocab": 12,
    "model.compute_dtype": "float32",
    "model.dropout_rate": 0.0,
    "data.dataset": "synthetic",
    "data.n_mels": 8,
    "data.bucket_sizes": (64,),
    "data.batch_size": 4,
    "data.max_label_len": 16,
    "data.num_synthetic": 16,
    "decode.beam_width": 4,
    "train.num_steps": 3,
    "train.warmup_steps": 1,
    "train.learning_rate": 3e-3,
    "train.weight_decay": 1e-2,
    "train.grad_clip": 1.0,
}


def _cfgs(**extra):
    over = {**OVERRIDES, **extra}
    return (jget_config("librispeech_qlstm").override(**over),
            get_config("librispeech_qlstm").override(**over))



@pytest.fixture(scope="module")
def qlstm_batches():
    jcfg, _ = _cfgs()
    data = JSyntheticDataset(vocab=jcfg.model.vocab, n_mels=jcfg.data.n_mels,
                             num_examples=jcfg.data.num_synthetic, seed=0)
    stream = JBatchStream(data, jcfg.data, seed=0)
    batches = [next(stream) for _ in range(3)]
    for batch in batches:  # ragged: the recurrences must see the lengths
        lens = batch["feature_lengths"]
        assert lens.min() < lens.max() < batch["features"].shape[1]
    return batches


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_encoder_grads(qlstm_batches):
    """The JAX encoder's weights (random biases) and its loss and gradients
    on the first batch, each one jitted computation."""
    jcfg, _ = _cfgs()
    jb = _jbatch(qlstm_batches[0])
    jmodel = jbuild_model(jcfg)
    assert jmodel.recurrent == "fast8"
    tree = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb["features"])["params"]
    tree = _random_biases(jax.tree.map(np.asarray, tree), seed=8)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jb["features"], train=False,
                              lengths=jb["feature_lengths"])
        losses = jctc_loss(logits, jb["labels"], jb["feature_lengths"], jb["label_lengths"])
        return (losses * jb["real_rows"]).sum() / jnp.maximum(
            (jb["label_lengths"] * jb["real_rows"]).sum(), 1)

    want_loss, want_g = jax.jit(jax.value_and_grad(jloss))(tree)
    return tree, float(want_loss), params_from_jax(jax.tree.map(np.asarray, want_g))


@pytest.mark.parametrize("recurrent", ["fast8", "pallas8"])
def test_encoder_param_grads_match_jax(qlstm_batches, jax_encoder_grads, recurrent):
    """The whole encoder's loss gradients on a ragged batch against the JAX
    encoder's (its fast8 recurrence, as JAX routes it off the TPU): the port
    on fast8 (autograd) and on pallas8 (QLstmScanFn with the plain versions),
    which in f32 compute the same function."""
    _, tcfg = _cfgs()
    batch = qlstm_batches[0]
    tree, want_loss, want = jax_encoder_grads
    m = tcfg.model
    port = QLSTMEncoder(
        n_feats=tcfg.data.n_mels, conv_features=m.conv_features,
        dense_features=m.dense_features, lstm_features=m.lstm_features,
        lstm_layers=m.lstm_layers, vocab=m.vocab, dropout_rate=0.0, recurrent=recurrent,
        device="cpu",
    ).eval()
    port.load_state_dict(params_from_jax(tree), strict=True)
    tb = batch_to_device(batch, torch.device("cpu"))
    loss = loss_fn(tcfg, port(tb["features"], lengths=tb["feature_lengths"]), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    got = _port_grads(port)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k, **TOL_GRAD)


def test_train_step_matches_jax(qlstm_batches):
    """Three steps of ``make_train_step`` against the port's train_step on a
    small qlstm from bridged weights, batches with ragged feature_lengths:
    loss, grad norm, frames and every param after each step; then the eval
    step. Without the lengths the backward direction would read the padding
    and the loss would differ."""
    jcfg, tcfg = _cfgs()
    batches = qlstm_batches
    jstate = jax.jit(lambda f: jcreate_train_state(jcfg, jax.random.PRNGKey(0), f))(
        batches[0]["features"])
    state = create_train_state(
        tcfg, device="cpu", params=params_from_jax(jax.tree.map(np.array, jstate.params))
    )
    assert state.model.recurrent == "fast8" and state.model.training
    jstep = make_train_step(jcfg)
    norms = []
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, _jbatch(batch))
        m = train_step(state, batch)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        assert m["frames"].item() == int(jm["frames"])
        norms.append(float(jm["grad_norm"]))
        want = params_from_jax(jax.tree.map(np.array, jstate.params))
        got = state.model.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=5e-5,
                                       err_msg=f"step {i}: {k}")
    assert state.step == int(jstate.step) == 3
    assert any(n > tcfg.train.grad_clip for n in norms)

    batch = batches[0]
    want = make_eval_step(jcfg)(jstate.params, _jbatch(batch))
    got = eval_step(tcfg, state.model, batch)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["decoded_lengths"].numpy(),
                                  np.asarray(want["decoded_lengths"]))
    np.testing.assert_array_equal(got["decoded"].numpy(), np.asarray(want["decoded"]))


def test_padded_batch_loss_equals_unpadded(qlstm_batches):
    """train_step and eval_step pass the lengths: a batch padded to 64
    frames gives the loss of the same utterances cut to their longest frame
    count. Without the lengths the padding (zero features, which the random
    biases turn into nonzero gate inputs) reaches the backward direction's
    state and the loss moves (measured: 1.9e-4 relative, against the 1e-5
    that holds the two equal)."""
    _, tcfg = _cfgs()
    padded = qlstm_batches[1]
    n = int(padded["feature_lengths"].max())
    assert n < padded["features"].shape[1]
    cut = {**padded, "features": padded["features"][:, :n]}
    model = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    params = model.state_dict()
    losses = []
    for batch in (padded, cut):
        state = create_train_state(tcfg, device="cpu", params=params)
        losses.append((train_step(state, batch)["loss"].item(),
                       eval_step(tcfg, model, batch)["loss"].item()))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    tb = batch_to_device(padded, torch.device("cpu"))
    with torch.no_grad():
        leaked = loss_fn(tcfg, model(tb["features"]), tb).item()
    assert abs(leaked - losses[0][1]) > 5e-5 * abs(losses[0][1])


def test_qlstm_dropout_in_train_mode_only():
    """Dropout after each QBiLSTM and after the dense PReLU draws from the
    generator the caller passes, in train mode only."""
    _, tcfg = _cfgs(**{"model.dropout_rate": 0.5})
    model = create_train_state(tcfg, device="cpu").model
    assert model.training and model.lstm_dropout_0.rate == 0.5
    x = _t(np.random.default_rng(9).standard_normal((2, 20, 8, 4)).astype(np.float32))
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(5))
        b = model(x, generator=torch.Generator().manual_seed(5))
        c = model(x, generator=torch.Generator().manual_seed(6))
        model.eval()
        e = model(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a, e)


def test_train_loop_qlstm_checkpoint_serves(tmp_path):
    """train() of the small qlstm on synthetic data: two steps, an eval (the
    error rate over the synthetic symbols, no TIMIT fold), a checkpoint that
    a Transcriber loads as it is (its symbols are the synthetic set's) and
    that serves character strings under the LibriSpeech config."""
    _, tcfg = _cfgs(**{"train.num_steps": 2, "train.log_every": 1, "train.eval_every": 2,
                       "train.checkpoint_every": 2})
    state, last = train(tcfg, device="cpu", checkpoint_dir=str(tmp_path))
    assert state.step == 2
    assert np.isfinite(last["loss"]) and np.isfinite(last["grad_norm"])
    assert 0.0 <= last["dev_per"] <= 1.5
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 2]
    tr = Transcriber(last["checkpoint"], device="cpu")
    assert isinstance(tr.model, QLSTMEncoder) and not tr.model.training
    sd = state.model.state_dict()
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    wavs = [np.random.default_rng(0).standard_normal(n).astype(np.float32) * 0.1
            for n in (4000, 2500)]
    assert len(tr.transcribe_batch(wavs)) == 2
    chars = Transcriber(cfg=tr.cfg.override(**{"data.dataset": "librispeech"}),
                        params=tr.model.state_dict(), device="cpu")
    out = chars.transcribe_batch(wavs)
    assert len(out) == 2 and all(isinstance(s, str) for s in out)
