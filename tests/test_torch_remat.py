"""``train.remat_convs``: the conv tower recomputed layer by layer in the
backward (``qasr_torch.models.qcnn.segment``), against the JAX package's
``jax.checkpoint`` over the train forward (``qasr/train/step.py:35-38``).

The reference's two ``TestRemat`` cases (``tests/test_train.py:301, 323``)
run on both packages at weights the JAX package draws and the bridge
carries: one tiny_synthetic train step with remat on (dropout 0, so that
the two packages' masks cannot differ), loss rtol 1e-5 and grad norm 1e-4
as the reference's own test; and a stacked 8 -> 128 tower (``stacked8``,
the rank-8 chain whose backward is the port's custom autograd function),
whose gradients with remat are the port's without remat bit for bit and
the JAX package's within 1e-4 of each gradient's largest element. Then, in
the port alone (f32): every arch's gradients with remat on equal those
with it off bit for bit, with dropout 0.3 on the dense layers (outside the
segments); and each conv layer's forward runs twice in a step with remat,
once without, in one process and in the sharded step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.configs import get_config as jget_config
from qasr.data.batching import epoch_iterator as jepoch_iterator
from qasr.data.synthetic import SyntheticDataset as JSyntheticDataset
from qasr.models.qcnn import QCNNEncoder as JQCNNEncoder
from qasr.train.state import create_train_state as jcreate_train_state
from qasr.train.step import make_train_step
from qasr_torch.bridge import params_from_jax
from qasr_torch.configs import get_config
from qasr_torch.models import build_model
from qasr_torch.models.layers import Conv, QConv
from qasr_torch.parallel import create_sharded_train_state, make_mesh, make_sharded_train_step
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import batch_to_device, forward_backward, train_step

torch.set_num_threads(1)


def test_remat_step_matches_jax():
    """tiny_synthetic, one train step with ``train.remat_convs``: the JAX
    step with remat and the port's at the same weights and batch."""
    over = {"train.num_steps": 5, "train.remat_convs": True}
    jcfg = jget_config("tiny_synthetic").override(**over)
    tcfg = get_config("tiny_synthetic").override(**over)
    assert jcfg.model.dropout_rate == tcfg.model.dropout_rate == 0.0
    ds = JSyntheticDataset(vocab=jcfg.model.vocab, n_mels=jcfg.data.n_mels, num_examples=8,
                           seed=0)
    batch = dict(next(iter(jepoch_iterator(ds, jcfg.data, train=False))))
    jstate = jax.jit(lambda f: jcreate_train_state(jcfg, jax.random.PRNGKey(0), f))(
        jnp.asarray(batch["features"]))
    params = params_from_jax(jax.tree.map(np.array, jstate.params))
    _, jm = make_train_step(jcfg)(jstate, batch)
    state = create_train_state(tcfg, device="cpu", params=params)
    m = train_step(state, batch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)


def test_remat_composes_with_stacked_chain():
    """The rank-8 stacked chain (``op_variant=stacked8``, conv (8, 128)):
    the gradients of ``sum(logits**2)`` with remat equal those without bit
    for bit, and the JAX package's ``jax.checkpoint`` gradients."""
    jm = JQCNNEncoder(variant="stacked8", conv_features=(8, 128), dense_features=(8,),
                      vocab=8, pool_after=1)
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, 16, 40, 4)))
    p = jax.jit(lambda a: jm.init(jax.random.PRNGKey(1), a, train=False))(jnp.asarray(x))["params"]

    def loss(q):
        return jnp.sum(jm.apply({"params": q}, jnp.asarray(x), train=False) ** 2)

    jgrads = params_from_jax(jax.tree.map(np.array, jax.jit(jax.grad(jax.checkpoint(loss)))(p)))
    cfg = get_config("tiny_synthetic").override(**{
        "model.op_variant": "stacked8", "model.conv_features": (8, 128),
        "model.dense_features": (8,), "model.vocab": 8, "model.compute_dtype": "float32",
        "data.n_mels": 40,
    })
    model = build_model(cfg, device="cpu")
    assert model.stacked == [False, True]
    model.load_state_dict(params_from_jax(jax.tree.map(np.array, p)))
    grads = {}
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        model(torch.from_numpy(x), remat=remat).square().sum().backward()
        grads[remat] = {k: q.grad.clone() for k, q in model.named_parameters()}
    for k, g in grads[True].items():
        assert torch.equal(g, grads[False][k]), k
        want = jgrads[k].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-4 * scale, err_msg=k)


# one config per arch, f32, dropout 0.3 (on the dense and LSTM layers)
_ARCHS = {
    "qcnn": ("tiny_synthetic", {"model.conv_features": (8, 16, 16)}),
    "real_cnn": ("tiny_synthetic", {"model.arch": "real_cnn", "model.conv_features": (4, 8)}),
    "qlstm": ("librispeech_qlstm", {"model.conv_features": (8, 16), "model.lstm_features": 8,
                                    "model.lstm_layers": 1, "model.vocab": 12}),
    "real_lstm": ("librispeech_qlstm", {"model.arch": "real_lstm", "model.conv_features": (4, 8),
                                        "model.lstm_features": 4, "model.lstm_layers": 1,
                                        "model.vocab": 12}),
}


def _cfg(arch, remat):
    preset, over = _ARCHS[arch]
    return get_config(preset).override(**over, **{
        "model.dense_features": (16,), "model.compute_dtype": "float32",
        "model.dropout_rate": 0.3, "data.n_mels": 8, "train.remat_convs": remat})


def _batch():
    rng = np.random.default_rng(0)
    return {"features": rng.standard_normal((2, 24, 8, 4)).astype(np.float32),
            "feature_lengths": np.array([24, 19]), "labels": rng.integers(1, 10, (2, 5)),
            "label_lengths": np.array([5, 3])}


class _ForwardCount:
    """Counts the calls of the conv layers' ``forward`` (QConv for the
    quaternion towers, Conv for the real ones)."""

    def __init__(self, monkeypatch):
        self.n = 0
        for cls in (QConv, Conv):
            monkeypatch.setattr(cls, "forward", self._wrap(cls.forward))

    def _wrap(self, fn):
        def counted(module, *a, **k):
            self.n += 1
            return fn(module, *a, **k)
        return counted


@pytest.mark.parametrize("arch", list(_ARCHS))
def test_remat_recomputes_the_tower_with_the_same_gradients(arch, monkeypatch):
    """With remat each conv layer's forward runs twice in a step (the
    backward recomputes it), without remat once; the loss and every
    gradient are the same bits."""
    calls = _ForwardCount(monkeypatch)
    n_conv = len(_ARCHS[arch][1]["model.conv_features"])
    out = {}
    for remat in (False, True):
        cfg = _cfg(arch, remat)
        state = create_train_state(cfg, device="cpu")
        calls.n = 0
        loss = forward_backward(state, batch_to_device(_batch(), torch.device("cpu")))
        assert calls.n == n_conv * (2 if remat else 1), (remat, calls.n)
        out[remat] = loss, {k: p.grad for k, p in state.model.named_parameters()}
    assert torch.equal(out[True][0], out[False][0])
    for k, g in out[True][1].items():
        assert torch.equal(g, out[False][1][k]), k


def test_sharded_step_recomputes_the_tower(monkeypatch):
    """The sharded train step (a world of one) reads ``train.remat_convs``
    too: the tower runs twice, and the step's metrics and weights are those
    of the one-process step with remat."""
    calls = _ForwardCount(monkeypatch)
    cfg = _cfg("qcnn", True)
    single = create_train_state(cfg, device="cpu")
    state, _ = create_sharded_train_state(cfg, make_mesh(), device="cpu")
    step = make_sharded_train_step(cfg, make_mesh())
    m1 = train_step(single, _batch())
    calls.n = 0
    m2 = step(state, _batch())
    assert calls.n == 2 * 3
    for k in ("loss", "grad_norm"):
        assert torch.equal(m1[k], m2[k]), k
    for (k, p), q in zip(single.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(p, q), k
