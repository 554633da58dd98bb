"""Config 4's real ablation (``arch="real_lstm"``) against the JAX package:
``RealBiLSTM`` and ``RealLSTMEncoder`` (``qasr/models/qlstm.py:379-499``),
their init, ``build_model``, serving, the command line and the bridge.

Inputs come from numpy with a seed; weights are drawn by the JAX package and
bridged into the port; each JAX reference is one ``jax.jit``. The port runs
no kernel of its own here (cuBLAS products and cuDNN convs on the card).

Tolerances, f32: 1e-5 for a layer, 1e-4 for the encoder's logits and
gradients (the products sum in another order). bf16: the JAX input product
sums in f32 and rounds once, as a bf16 GEMM does; both packages carry h and
c in bf16, but XLA keeps each step's elementwise chain in f32 between its
roundings where PyTorch rounds every op, so the outputs differ by a few
bf16 ulps: rel-norm 1e-2, largest difference 3e-2, as
tests/test_torch_qlstm_arms.py holds the quaternion layers.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from qasr.configs import get_config as jget_config
from qasr.models import qlstm as jqlstm
from qasr.ops.ctc import ctc_loss as jctc_loss
from qasr.train.state import build_model as jbuild_model
from qasr_torch.bridge import params_from_jax, params_to_jax
from qasr_torch.cli import main
from qasr_torch.configs import get_config
from qasr_torch.infer import Transcriber
from qasr_torch.models import build_model
from qasr_torch.models.qlstm import RealBiLSTM, RealLSTMEncoder
from qasr_torch.train.step import batch_to_device, loss_fn
from tests.test_torch_qlstm import _random_biases
from tests.test_torch_qlstm_arms import BF16_MAX, BF16_REL_NORM

torch.set_num_threads(1)
TOL_LAYER = dict(rtol=1e-5, atol=1e-5)
TOL_ENC = dict(rtol=1e-4, atol=1e-4)

OVER = {
    "model.arch": "real_lstm", "model.conv_features": (4, 8), "model.lstm_features": 6,
    "model.lstm_layers": 2, "model.dense_features": (8,), "model.vocab": 12,
    "model.compute_dtype": "float32", "model.dropout_rate": 0.0, "data.n_mels": 8,
    "data.bucket_sizes": (64, 128), "decode.beam_width": 4,
}
JCFG = jget_config("librispeech_qlstm").override(**OVER)
CFG = get_config("librispeech_qlstm").override(**OVER)


def _layer_inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 11, 20)) * 0.5).astype(np.float32)
    return x, np.array([11, 6, 2], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_lengths", [False, True])
def test_real_bilstm_matches_jax(use_lengths, dtype):
    """One ``RealBiLSTM`` (24 real units) against the JAX layer, ragged
    lengths: the input product of both directions, real gates i, f, o, g,
    the backward direction on the flipped stream."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x, lengths = _layer_inputs()
    ref = jqlstm.RealBiLSTM(hidden=24, dtype=jdt)
    params = jax.jit(ref.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = _random_biases(params, seed=2)
    ll = jnp.asarray(lengths) if use_lengths else None
    want = jax.jit(lambda p, xx, l_: ref.apply({"params": p}, xx, l_))(params, jnp.asarray(x), ll)
    want = np.asarray(want.astype(jnp.float32))
    port = RealBiLSTM(20, 24, dtype=tdt, device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(lengths) if use_lengths else None)
    assert got.dtype == tdt and got.shape == (3, 11, 48)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL_LAYER)
    else:
        assert np.linalg.norm(got - want) <= BF16_REL_NORM * np.linalg.norm(want)
        assert np.abs(got - want).max() <= BF16_MAX


def test_real_bilstm_init_is_flax_glorot_uniform():
    """flax's ``glorot_uniform`` on ``[2, In, 4H]`` counts the leading 2 as
    receptive field: uniform on +-sqrt(6 / (2 In + 2 x 4H)), not on the
    per-direction +-sqrt(6 / (In + 4H)). Both packages' draws fill that
    interval (a KS test each) and no wider; the bias is zero."""
    cin, hid = 50, 40
    port = RealBiLSTM(cin, hid, generator=torch.Generator().manual_seed(3), device="cpu")
    jw = fnn.initializers.glorot_uniform()(jax.random.PRNGKey(3), (2, cin, 4 * hid))
    for name, shape in (("wx", (2, cin, 4 * hid)), ("wh", (2, hid, 4 * hid))):
        w = getattr(port, name).detach().numpy()
        assert w.shape == shape
        limit = math.sqrt(6.0 / (2 * shape[1] + 2 * shape[2]))
        for draw in (w.ravel(), np.asarray(jw).ravel() if name == "wx" else w.ravel()):
            assert np.abs(draw).max() <= limit
            assert stats.kstest(draw, "uniform", args=(-limit, 2 * limit)).pvalue > 1e-3
        per_direction = math.sqrt(6.0 / (shape[1] + shape[2]))
        assert np.abs(w).max() < 0.8 * per_direction
    assert not port.bias.detach().any() and port.bias.shape == (2, 4 * hid)


@pytest.fixture(scope="module")
def jax_real_encoder():
    """The JAX ``RealLSTMEncoder`` of CFG (random biases), its logits and
    its loss gradients on one ragged batch, one jit each."""
    model = jbuild_model(JCFG)
    assert type(model).__name__ == "RealLSTMEncoder"
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 21, 8, 4)).astype(np.float32)
    lengths = np.array([21, 13, 4], np.int32)
    x[np.arange(21)[None, :] >= lengths[:, None]] = 0.0
    batch = {"features": x, "feature_lengths": lengths,
             "labels": rng.integers(1, 12, size=(3, 3)).astype(np.int32),
             "label_lengths": np.array([3, 2, 2], np.int32), "real_rows": np.ones(3, bool)}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _random_biases(jax.tree.map(np.asarray, params), seed=5)

    def jlogits(p):
        return model.apply({"params": p}, jnp.asarray(x), train=False,
                           lengths=jnp.asarray(lengths))

    def jloss(p):
        losses = jctc_loss(jlogits(p), jnp.asarray(batch["labels"]), jnp.asarray(lengths),
                           jnp.asarray(batch["label_lengths"]))
        return losses.sum() / batch["label_lengths"].sum()

    logits = np.asarray(jax.jit(jlogits)(params))
    grads = jax.jit(jax.grad(jloss))(params)
    return params, batch, logits, params_from_jax(jax.tree.map(np.asarray, grads))


def test_real_lstm_encoder_matches_jax(jax_real_encoder):
    """``build_model(arch="real_lstm")`` against JAX's on bridged weights:
    the logits with ragged lengths, and every parameter's loss gradient."""
    params, batch, want, want_g = jax_real_encoder
    port = build_model(CFG, device="cpu")
    assert type(port) is RealLSTMEncoder and not port.training
    port.load_state_dict(params_from_jax(params), strict=True)
    tb = batch_to_device(batch, torch.device("cpu"))
    logits = port(tb["features"], lengths=tb["feature_lengths"])
    np.testing.assert_allclose(logits.detach().numpy(), want, **TOL_ENC)
    loss_fn(CFG, logits, tb).backward()
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(got) == set(want_g)
    for k in got:
        np.testing.assert_allclose(got[k], want_g[k].numpy(), err_msg=k, **TOL_ENC)


def test_real_lstm_bridge_round_trip(jax_real_encoder):
    """JAX -> port -> JAX for a ``RealLSTMEncoder`` tree and a
    ``RealBiLSTM`` one: the same names, the same bits."""
    params = jax_real_encoder[0]
    port = build_model(CFG, device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    assert {"bilstm_1.wx", "bilstm_1.wh", "bilstm_1.bias", "conv_0.kernel", "dense_0.kernel",
            "output.bias"} <= set(port.state_dict())
    back = params_to_jax(port.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    layer = RealBiLSTM(5, 3, device="cpu")
    tree = params_to_jax(layer.state_dict())
    assert set(tree) == {"wx", "wh", "bias"}
    layer2 = RealBiLSTM(5, 3, device="cpu")
    layer2.load_state_dict(params_from_jax(tree), strict=True)
    for k, v in layer.state_dict().items():
        torch.testing.assert_close(layer2.state_dict()[k], v, rtol=0, atol=0)


def test_real_lstm_unidirectional_raises():
    with pytest.raises(NotImplementedError, match="real ablation is bidirectional-only"):
        build_model(CFG.override(**{"model.bidirectional": False}), device="cpu")
    with pytest.raises(NotImplementedError, match="real ablation is bidirectional-only"):
        RealLSTMEncoder(n_feats=8, bidirectional=False, device="cpu")


def test_real_lstm_trains_through_cli_and_serves(tmp_path):
    """``python -m qasr_torch.cli --preset librispeech_qlstm --set
    model.arch=real_lstm`` trains (on synthetic data) and evaluates; its
    checkpoint serves through ``Transcriber``."""
    sets = [f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
            for k, v in OVER.items()]
    sets += ["data.dataset=synthetic", "data.num_synthetic=8", "data.batch_size=4",
             "data.max_label_len=8", "train.num_steps=2", "train.eval_every=2",
             "train.checkpoint_every=2", "train.warmup_steps=1", "train.log_every=1",
             f"train.checkpoint_dir={tmp_path}"]
    last = main(["--preset", "librispeech_qlstm", "--device", "cpu", "--set", *sets])
    assert np.isfinite(last["loss"]) and np.isfinite(last["dev_loss"]), last
    wavs = [(0.1 * np.random.default_rng(5).standard_normal(n)).astype(np.float32)
            for n in (7000, 3000)]
    tr = Transcriber(last["checkpoint"], device="cpu")
    assert type(tr.model) is RealLSTMEncoder
    out = tr.transcribe_batch(wavs)
    assert len(out) == 2
