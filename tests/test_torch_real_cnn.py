"""The qasr_torch real-CNN baseline (config 3, ``timit_real_cnn``) against the
JAX package's ``RealCNNEncoder``.

A small model (conv (4, 4, 8): real channels 16, 16, 32; dense (16,): 64
units; vocab 12; 8 mels; pool 3) is initialised by the JAX package from a
seed, its biases and PReLU slopes drawn away from zero and 0.25 with numpy,
and bridged into the port; both sides take the same numpy inputs.

Tolerances: f32 forward rel-norm 1e-5 (convs and GEMMs summing in another
order, ~1e-7 each); bf16 forward rel-norm 2e-2 (both round at every layer
boundary, ~4e-3 each, at places that differ: the port's cuDNN conv adds
the bias before its one rounding, flax's after); one f32 train step: loss
and grad norm rtol 1e-5, params after the step 1e-4.
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from qasr.configs import get_config as jget_config
from qasr.data.batching import BatchStream as JBatchStream
from qasr.data.synthetic import SyntheticDataset as JSyntheticDataset
from qasr.models.qcnn import RealCNNEncoder as JRealCNNEncoder
from qasr.train.state import build_model as jbuild_model
from qasr.train.state import create_train_state as jcreate_train_state
from qasr.train.step import make_train_step
from qasr_torch.bridge import params_from_jax, params_to_jax
from qasr_torch.cli import main, transcribe_main
from qasr_torch.configs import get_config
from qasr_torch.infer import Transcriber
from qasr_torch.models import build_model
from qasr_torch.models.qcnn import RealCNNEncoder
from qasr_torch.ops.initializers import lecun_normal
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import train_step

torch.set_num_threads(1)

OVERRIDES = {
    "model.conv_features": (4, 4, 8),
    "model.dense_features": (16,),
    "model.vocab": 12,
    "model.compute_dtype": "float32",
    "model.dropout_rate": 0.0,
    "data.dataset": "synthetic",
    "data.n_mels": 8,
    "data.bucket_sizes": (32,),
    "data.batch_size": 4,
    "data.max_label_len": 8,
    "data.num_synthetic": 8,
    "train.num_steps": 1,
    "train.warmup_steps": 0,
    "train.learning_rate": 3e-3,
    "train.weight_decay": 1e-2,
}


def _cfgs(**extra):
    over = {**OVERRIDES, **extra}
    return (jget_config("timit_real_cnn").override(**over),
            get_config("timit_real_cnn").override(**over))


def _randomised(tree, seed):
    """The JAX init with its zero biases and 0.25 slopes redrawn, so that
    the bias adds and both PReLU branches' slopes are pinned."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(path[-1].key)
        if name == "bias":
            return (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        if name == "alpha":
            return rng.uniform(-0.5, 0.8, a.shape).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray, tree))


def _models(dtype):
    jcfg, tcfg = _cfgs(**{"model.compute_dtype": dtype})
    x = np.random.default_rng(0).standard_normal((2, 12, 8, 4)).astype(np.float32)
    jmodel = jbuild_model(jcfg)
    assert isinstance(jmodel, JRealCNNEncoder)
    tree = _randomised(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                       seed=1)
    port = build_model(tcfg, device="cpu")
    port.load_state_dict(params_from_jax(tree), strict=True)
    return jmodel, tree, port, x


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_forward_matches_jax(dtype, tol):
    """Logits of the port's encoder against the JAX one's on bridged weights,
    f32 out of both."""
    jmodel, tree, port, x = _models(dtype)
    want = np.asarray(jax.jit(lambda p, xx: jmodel.apply({"params": p}, xx))(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), lengths=torch.tensor([12, 7]))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 12)
    assert _rel(got.numpy(), want) <= tol


def test_train_step_matches_jax():
    """One ``make_train_step`` against the port's train_step from bridged
    weights, dropout 0: loss, grad norm and every param after the step."""
    jcfg, tcfg = _cfgs()
    data = JSyntheticDataset(vocab=jcfg.model.vocab, n_mels=jcfg.data.n_mels,
                             num_examples=jcfg.data.num_synthetic, seed=0)
    batch = next(JBatchStream(data, jcfg.data, seed=0))
    jstate = jax.jit(lambda f: jcreate_train_state(jcfg, jax.random.PRNGKey(0), f))(
        batch["features"])
    jstate = jstate.replace(params=_randomised(jstate.params, seed=2))
    state = create_train_state(tcfg, device="cpu", params=params_from_jax(jstate.params))
    assert isinstance(state.model, RealCNNEncoder) and state.model.training
    jstate, jm = make_train_step(jcfg)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    m = train_step(state, batch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.array, jstate.params))
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_build_model_routes_real_cnn():
    """``arch="real_cnn"`` builds the port's RealCNNEncoder with the JAX
    names and shapes, in eval or train mode; the switches the JAX
    build_model does not pass are not read."""
    jmodel, tree, _, x = _models("float32")
    want = {k: tuple(v.shape) for k, v in params_from_jax(tree).items()}
    _, tcfg = _cfgs(**{"model.dropout_rate": 0.3})
    for over in ({}, {"model.op_variant": "fused", "model.dense_variant": "pallas",
                      "model.use_pallas": True}):
        for train in (False, True):
            model = build_model(tcfg.override(**over), device="cpu", train=train)
            assert isinstance(model, RealCNNEncoder) and model.training == train
            assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert want["conv_0.kernel"] == (3, 3, 4, 16) and want["dense_0.kernel"] == (2 * 32, 64)
    assert model.dense_dropout_0.rate == 0.3


def test_dropout_in_train_mode_only():
    """Dropout after the dense PReLU draws from the generator the caller
    passes, in train mode only."""
    _, tcfg = _cfgs(**{"model.dropout_rate": 0.5})
    model = build_model(tcfg, device="cpu", train=True, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 10, 8, 4)).astype("f4"))
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(5))
        b = model(x, generator=torch.Generator().manual_seed(5))
        c = model(x, generator=torch.Generator().manual_seed(6))
        e = model.eval()(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c) and not torch.allclose(a, e)


def test_lecun_normal_distribution():
    """flax's lecun_normal, by distribution (torch.Generator is not JAX's
    PRNG): a unit normal truncated to [-2, 2] at scale sqrt(1 / fan_in) /
    0.8796, fan_in counting the receptive field."""
    g = torch.Generator().manual_seed(6)
    w = lecun_normal((3, 3, 40, 300), generator=g).numpy().ravel()
    std = np.sqrt(1.0 / (9 * 40)) / 0.87962566103423978
    _, p = stats.kstest(w / std, stats.truncnorm(-2.0, 2.0).cdf)
    assert p > 1e-3
    np.testing.assert_allclose(np.var(w), 1.0 / (9 * 40), rtol=0.03)
    want = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (3, 3, 40, 300)))
    np.testing.assert_allclose(np.var(w), np.var(want), rtol=0.03)


def test_params_to_jax_round_trips():
    """The bridge both ways: the port's state_dict as a JAX tree comes back
    unchanged, and gives the JAX encoder the port's logits."""
    jmodel, _, _, x = _models("float32")
    _, tcfg = _cfgs()
    port = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(7))
    tree = params_to_jax(port.state_dict())
    back = params_from_jax(tree)
    assert set(back) == set(port.state_dict())
    for k, v in port.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    want = np.asarray(jax.jit(lambda p, xx: jmodel.apply({"params": p}, xx))(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= 1e-5


def test_cli_trains_and_serves_real_cnn(tmp_path):
    """``python -m qasr_torch.cli --preset timit_real_cnn`` (narrowed, on
    synthetic data) trains and checkpoints; the checkpoint serves greedy
    and beam through ``transcribe_main`` and a Transcriber."""
    last = main(["--preset", "timit_real_cnn", "--device", "cpu", "--set", "data.dataset=synthetic",
                 "model.conv_features=(4,4)", "model.dense_features=(8,)", "data.n_mels=8",
                 "data.bucket_sizes=(32,)", "data.batch_size=2", "data.num_synthetic=4",
                 "model.vocab=12", "train.num_steps=2", "train.log_every=1", "train.eval_every=2",
                 "train.checkpoint_every=2", f"train.checkpoint_dir={tmp_path}"])
    assert np.isfinite(last["loss"]) and "dev_per" in last
    tr = Transcriber(last["checkpoint"], device="cpu")
    assert isinstance(tr.model, RealCNNEncoder) and not tr.model.training
    pcm = (np.random.default_rng(4).standard_normal(8000) * 2000).astype(np.int16)
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    for beam in ([], ["--beam"]):
        out = transcribe_main(["--ckpt", str(tmp_path), "--device", "cpu", *beam, str(path)])
        assert len(out) == 1

