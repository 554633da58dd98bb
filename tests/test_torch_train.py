"""The qasr_torch training step as a whole, and each piece of it, against
the JAX package.

A small qcnn (conv (8, 16, 16), dense (16,), 8 mels, f32, dropout 0) is
initialised by the JAX package from a seed and bridged into the port; both
sides then take the same three batches of the same synthetic data. On the
CPU the port runs its kernels' plain versions (the stacked layers through
kernel A's plain version, JAX through its block path at these widths).

Tolerances, f32: loss and grad norm rtol 1e-5 (one scalar each, sums in
another order); params after each update rtol/atol 1e-5 (an Adam step moves
each weight by at most ~lr = 3e-3, and the gradient difference of ~1e-6
relative moves it by far less); the optimizer and the schedule alone to
1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qasr.configs import get_config as jget_config
from qasr.data.batching import BatchStream as JBatchStream
from qasr.data.batching import epoch_iterator as jepoch_iterator
from qasr.data.synthetic import SyntheticDataset as JSyntheticDataset
from qasr.ops.ctc import ctc_loss as jctc_loss
from qasr.train.state import build_model as jbuild_model
from qasr.train.state import build_optimizer as jbuild_optimizer
from qasr.train.state import create_train_state as jcreate_train_state
from qasr.train.step import make_eval_step, make_loss_fn, make_train_step
from qasr_torch.bridge import params_from_jax, params_to_jax
from qasr_torch.configs import get_config
from qasr_torch.data.batching import BatchStream, epoch_iterator
from qasr_torch.data.synthetic import SyntheticDataset
from qasr_torch.infer import Transcriber
from qasr_torch.models.layers import Dropout
from qasr_torch.ops.ctc import INFEASIBLE_LOSS, ctc_loss
from qasr_torch.train.loop import train
from qasr_torch.train.state import (
    TrainState,
    build_optimizer,
    create_train_state,
    warmup_cosine_schedule,
)
from qasr_torch.train.step import apply_gradients, eval_step, loss_fn, train_step

torch.set_num_threads(1)

OVERRIDES = {
    "model.conv_features": (8, 16, 16),
    "model.dense_features": (16,),
    "model.compute_dtype": "float32",
    "model.dropout_rate": 0.0,
    "data.n_mels": 8,
    "data.bucket_sizes": (64,),
    "data.batch_size": 4,
    "data.num_synthetic": 16,
    "train.num_steps": 3,
    "train.warmup_steps": 1,
    "train.learning_rate": 3e-3,
    "train.weight_decay": 1e-2,
    "train.grad_clip": 1.0,
}


def _cfgs(**extra):
    over = {**OVERRIDES, **extra}
    return (jget_config("tiny_synthetic").override(**over),
            get_config("tiny_synthetic").override(**over))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _batches(jcfg, n):
    data = JSyntheticDataset(vocab=jcfg.model.vocab, n_mels=jcfg.data.n_mels,
                             num_examples=jcfg.data.num_synthetic, seed=0)
    stream = JBatchStream(data, jcfg.data, seed=0)
    return [next(stream) for _ in range(n)]


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def test_ctc_loss_matches_reference_with_infeasible_row():
    """Per-utterance NLL and its gradient against ``qasr.ops.ctc.ctc_loss``.
    Row 1 cannot emit its labels (4 repeats need 7 frames, it has 6): the
    reference reports its log-space floor, a finite 1e30, with a zero
    gradient; so does the port. Row 2 has no labels."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((4, 12, 6)) * 3).astype(np.float32)
    labels = np.array([[1, 2, 3, 0, 0], [2, 2, 2, 2, 0], [0, 0, 0, 0, 0], [1, 2, 1, 2, 1]],
                      np.int32)
    frames = np.array([10, 6, 5, 12], np.int32)
    lab_lens = np.array([3, 4, 0, 5], np.int32)
    args = tuple(jnp.asarray(a) for a in (labels, frames, lab_lens))
    want = np.asarray(jctc_loss(jnp.asarray(logits), *args))
    cot = np.array([1.0, 1.0, 0.5, 2.0], np.float32)
    want_g = np.asarray(jax.grad(lambda lg: (jctc_loss(lg, *args) * cot).sum())(jnp.asarray(logits)))
    assert want[1] == np.float32(1e30) and not want_g[1].any()

    x = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(x, *(torch.from_numpy(a) for a in (labels, frames, lab_lens)))
    (got * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == torch.float32 and got[1].item() == np.float32(INFEASIBLE_LOSS)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    assert not x.grad[1].any()
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-4, atol=1e-5)


class _GivenLogits:
    """Stands in for the flax model in ``make_loss_fn``: its "params" are
    the logits, so the reference's loss runs on exactly the port's input."""

    @staticmethod
    def apply(variables, features, **kwargs):
        return variables["params"]


def test_loss_normalisation_matches_make_loss_fn():
    """Per-label-token normalisation with ``real_rows``: a pad row (here an
    infeasible one, whose 1e30 must not leak) counts in neither sum."""
    jcfg, tcfg = _cfgs()
    batch = _batches(jcfg, 1)[0]
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal(batch["features"].shape[:2] + (12,)) * 2).astype(np.float32)
    jloss = make_loss_fn(jcfg, _GivenLogits())
    for real in (None, np.array([True, True, True, False])):
        b = dict(batch)
        if real is None:
            b.pop("real_rows")
        else:
            b["real_rows"] = real
            b["labels"] = b["labels"].copy()
            b["labels"][3, :4] = 5  # 4 repeats in 6 frames: infeasible (7 needed)
            b["label_lengths"] = b["label_lengths"].copy()
            b["label_lengths"][3] = 4
            b["feature_lengths"] = b["feature_lengths"].copy()
            b["feature_lengths"][3] = 6
        want, _ = jloss(jnp.asarray(logits), _jbatch(b), jax.random.PRNGKey(0), False)
        tb = {k: torch.as_tensor(v) for k, v in b.items()}
        got = loss_fn(tcfg, torch.from_numpy(logits), tb)
        assert got.item() < 1e3
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,steps", [(3, 10), (0, 5), (5, 2)])
def test_schedule_matches_optax(warmup, steps):
    """optax.warmup_cosine_decay_schedule with the arguments of
    ``qasr/train/state.py:build_optimizer``, at the count before each
    update (step 0 gives lr 0 whenever there is a warmup)."""
    _, tcfg = _cfgs(**{"train.warmup_steps": warmup, "train.num_steps": steps,
                       "train.learning_rate": 2e-3})
    t = tcfg.train
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=t.learning_rate, warmup_steps=t.warmup_steps,
        decay_steps=max(t.num_steps, t.warmup_steps + 1), end_value=t.learning_rate * 0.05,
    )
    lr = warmup_cosine_schedule(tcfg)
    for s in range(steps + 3):
        np.testing.assert_allclose(lr(s), float(want(s)), rtol=1e-6, atol=1e-12)
    if warmup:
        assert lr(0) == 0.0


def test_clipped_adamw_matches_optax():
    """apply_gradients against ``qasr.train.state.build_optimizer``'s
    chain(clip_by_global_norm, adamw): four updates, clipped and not."""
    jcfg, tcfg = _cfgs(**{"train.warmup_steps": 2, "train.num_steps": 6,
                          "train.learning_rate": 1e-2})
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    tx = jbuild_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params.items()})
    state = TrainState(cfg=tcfg, model=module, optimizer=build_optimizer(tcfg, module.parameters()),
                       generator=torch.Generator(), schedule=warmup_cosine_schedule(tcfg))
    clipped = []
    for scale in (3.0, 0.1, 2.0, 0.2):  # global norms ~ 5 and ~ 0.3 against max 1
        grads = {k: (rng.standard_normal(v.shape) * scale / 3).astype(np.float32)
                 for k, v in params.items()}
        for k, p in module.items():
            p.grad = torch.from_numpy(grads[k].copy())
        gnorm = apply_gradients(state)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want_norm = float(optax.global_norm(grads))
        np.testing.assert_allclose(gnorm.item(), want_norm, rtol=1e-6)
        clipped.append(want_norm > tcfg.train.grad_clip)
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert state.step == 4 and any(clipped) and not all(clipped)


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------


def test_train_step_matches_jax():
    """Three steps of ``make_train_step`` against the port's train_step from
    bridged weights: loss, grad norm, frames and every param after each
    step; then the eval step's loss and greedy decode."""
    jcfg, tcfg = _cfgs()
    batches = _batches(jcfg, 3)
    jstate = jax.jit(lambda f: jcreate_train_state(jcfg, jax.random.PRNGKey(0), f))(
        batches[0]["features"])
    state = create_train_state(
        tcfg, device="cpu", params=params_from_jax(jax.tree.map(np.array, jstate.params))
    )
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
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i}: {k}")
    assert state.step == int(jstate.step) == 3
    assert any(n > tcfg.train.grad_clip for n in norms)  # clipping was exercised

    batch = batches[0]
    want = make_eval_step(jcfg)(jstate.params, _jbatch(batch))
    got = eval_step(tcfg, state.model, batch)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(got["decoded_lengths"].numpy(),
                                  np.asarray(want["decoded_lengths"]))
    np.testing.assert_array_equal(got["decoded"].numpy(), np.asarray(want["decoded"]))


def test_port_trained_params_load_into_jax_model():
    """The bridge the other way: a state_dict trained by the port, as a JAX
    tree, gives the JAX QCNNEncoder the port's logits."""
    jcfg, tcfg = _cfgs()
    batches = _batches(jcfg, 2)
    state = create_train_state(tcfg, device="cpu")
    for batch in batches:
        train_step(state, batch)
    tree = params_to_jax(state.model.state_dict())
    assert tree["qconv_1"]["kernel"].shape == (4, 3, 3, 8, 16)
    x = batches[0]["features"]
    jmodel = jbuild_model(jcfg)
    want = np.asarray(jax.jit(lambda p, xx: jmodel.apply({"params": p}, xx, train=False))(
        tree, jnp.asarray(x)))
    state.model.eval()
    with torch.no_grad():
        got = state.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# dropout, data, the loop
# ---------------------------------------------------------------------------


def test_dropout_rate_scaling_and_eval_identity():
    d = Dropout(0.3)
    x = torch.ones(200_000)
    y = d(x, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005  # ~3.5 sigma at n=2e5
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    torch.testing.assert_close(d(x, torch.Generator().manual_seed(0)), y, rtol=0, atol=0)
    assert not torch.equal(d(x, torch.Generator().manual_seed(1)), y)
    with pytest.raises(ValueError, match="Generator"):
        d(x)
    assert d.eval()(x) is x
    assert Dropout(0.0)(x) is x
    with pytest.raises(ValueError):
        Dropout(1.0)


def test_model_dropout_in_train_mode_only():
    _, tcfg = _cfgs(**{"model.dropout_rate": 0.5})
    state = create_train_state(tcfg, device="cpu")
    model = state.model
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 20, 8, 4)).astype(np.float32))
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(5))
        b = model(x, generator=torch.Generator().manual_seed(5))
        c = model(x, generator=torch.Generator().manual_seed(6))
        model.eval()
        e1, e2 = model(x), model(x, plain=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a, e1)
    torch.testing.assert_close(e1, e2, rtol=0, atol=0)


def test_batches_match_reference():
    """SyntheticDataset, BatchStream (across an epoch boundary, and after
    restore()) and the eval iterator's remainder batch against the
    reference's, for one seed; the top bucket truncates long utterances."""
    over = {"data.bucket_sizes": (16, 32), "data.batch_size": 4, "data.max_label_len": 5,
            "data.num_synthetic": 22}
    jcfg, tcfg = _cfgs(**over)
    kw = dict(vocab=12, n_mels=8, num_examples=22, seed=3)
    jds, tds = JSyntheticDataset(**kw), SyntheticDataset(**kw)
    for a, b in zip(jds, tds):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)

    def same(a, b):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k

    js, ts = JBatchStream(jds, jcfg.data, seed=7), BatchStream(tds, tcfg.data, seed=7)
    for _ in range(12):
        same(next(js), next(ts))
        assert js.state() == ts.state()
    assert ts.state()["epoch"] >= 1
    resumed = BatchStream(tds, tcfg.data, seed=7)
    resumed.restore(js.state())
    same(next(js), next(resumed))
    jev = list(jepoch_iterator(jds, jcfg.data, train=False))
    tev = list(epoch_iterator(tds, tcfg.data, train=False))
    assert len(jev) == len(tev) and any(not b["real_rows"].all() for b in tev)
    for a, b in zip(jev, tev):
        same(a, b)


def test_train_loop_checkpoint_serves(tmp_path):
    """train(): log and eval lines in metrics.jsonl, a checkpoint that the
    Transcriber loads as it is, and the JAX config format in it."""
    _, tcfg = _cfgs(**{"train.num_steps": 2, "train.log_every": 1, "train.eval_every": 2,
                       "train.checkpoint_every": 2})
    state, last = train(tcfg, device="cpu", checkpoint_dir=str(tmp_path))
    assert state.step == 2
    assert np.isfinite(last["loss"]) and np.isfinite(last["grad_norm"])
    assert last["audio_s_per_s"] > 0 and 0.0 <= last["dev_per"] <= 1.5
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 2] and "dev_per" in rows[-1]
    ckpt = tmp_path / "step_2"
    assert last["checkpoint"] == str(ckpt)
    assert jget_config("tiny_synthetic").from_json((ckpt / "config.json").read_text()) == \
        jget_config("tiny_synthetic").override(**{**OVERRIDES, "train.num_steps": 2,
                                                   "train.log_every": 1, "train.eval_every": 2,
                                                   "train.checkpoint_every": 2})
    tr = Transcriber(str(ckpt), device="cpu")
    sd = state.model.state_dict()
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    wav = np.random.default_rng(0).standard_normal(4000).astype(np.float32) * 0.1
    assert len(tr.transcribe_batch([wav])) == 1
