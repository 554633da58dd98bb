"""The 10-product slice as a whole against the JAX package, and the routing
table of ``qasr_torch.models.build_model``.

A small qcnn (conv (8, 128, 128), dense (16,), 8 mels, f32, dropout 0) is
initialised by the JAX package from a seed and bridged into the port, for
each ``op_variant`` in {fused, fusedchain, stacked}, ``dense_variant`` in
{pallas, auto} and ``use_pallas`` in {false, true}. Both sides then give
the logits of the same batch, the gradients of the same loss and one
``train_step`` (the JAX side ``make_train_step``). On the CPU the port runs
its kernels' plain versions (kernels F and G for the stacked layers, H and
I for the dense layers under ``pallas`` and for the im2col convs under
``use_pallas``). JAX at f32 runs ``fused`` and ``stacked`` through its XLA
twin ``qconv_fast10_stacked`` (``qconv_ft.supported`` asks for bf16) and
``fusedchain`` the same way (its chain needs bf16), so at f32 the three
op variants give JAX one program, and ``use_pallas`` (every conv packed,
every dense layer on ``qdense_pallas``) makes ``op_variant`` and
``dense_variant`` moot; its dense ``pallas`` layers and its ``use_pallas``
convs run the Pallas kernels interpreted (``tests/pallas_interpret.py``)
under jit. The JAX side therefore runs once for each of its three programs
(dense pallas or not, ``use_pallas``), each part one jitted computation,
and every port configuration is held against its program's results.

Tolerances, f32: logits rtol/atol 1e-4 (three conv layers of up to 9*128
products and two dense layers, summed in another order); the loss and the
grad norm rtol 1e-5; each gradient 1e-4 relative to its largest element
(sums over up to a few thousand rows in another order); the params after
one clipped AdamW update rtol/atol 1e-5, as tests/test_torch_train.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.configs import get_config as jget_config
from qasr.data.batching import BatchStream as JBatchStream
from qasr.data.synthetic import SyntheticDataset as JSyntheticDataset
from qasr.train.state import build_model as jbuild_model
from qasr.train.state import create_train_state as jcreate_train_state
from qasr.train.step import make_loss_fn, make_train_step
from qasr_torch.bridge import params_from_jax
from qasr_torch.configs import get_config
from qasr_torch.models import build_model, qlstm_routing
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import batch_to_device, loss_fn, train_step
from tests.pallas_interpret import hlo_interpret

torch.set_num_threads(1)

# The smallest model that pins the slice: a thin layer, then two of 128
# quaternion channels, the least the JAX package stacks (qcnn.py:87-98), so
# both sides take their stacked and im2col paths; one dense layer; f32.
OVERRIDES = {
    "model.conv_features": (8, 128, 128),
    "model.dense_features": (16,),
    "model.compute_dtype": "float32",
    "model.dropout_rate": 0.0,
    "data.n_mels": 8,
    "data.bucket_sizes": (32,),
    "data.batch_size": 2,
    "data.max_label_len": 6,
    "data.num_synthetic": 8,
    "train.warmup_steps": 1,
    "train.num_steps": 3,
    "train.learning_rate": 3e-3,
    "train.grad_clip": 1.0,
}


def _cfgs(**extra):
    over = {**OVERRIDES, **extra}
    return (jget_config("tiny_synthetic").override(**over),
            get_config("tiny_synthetic").override(**over))


def _batch(jcfg):
    data = JSyntheticDataset(vocab=jcfg.model.vocab, n_mels=jcfg.data.n_mels,
                             num_examples=jcfg.data.num_synthetic, seed=0)
    return next(JBatchStream(data, jcfg.data, seed=0))


def _close_rel(got, want, name, rel=1e-4):
    got, want = got.detach().numpy(), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale, err_msg=name)


_JAX_RUNS = {}


def _jax_run(dense_pallas: bool, use_pallas: bool):
    """The JAX package on its program for (dense pallas, use_pallas), once:
    the bridged initial params, the eval logits, the loss's gradients, and
    one ``make_train_step`` (its metrics and updated params)."""
    key = (dense_pallas, use_pallas)
    if key not in _JAX_RUNS:
        jcfg, _ = _cfgs(**{"model.op_variant": "fused", "model.use_pallas": use_pallas,
                           "model.dense_variant": "pallas" if dense_pallas else "auto"})
        batch = _batch(jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with hlo_interpret():
            jstate = jax.jit(lambda f: jcreate_train_state(jcfg, jax.random.PRNGKey(0), f))(
                jb["features"])
            jmodel = jbuild_model(jcfg)
            logits = jax.jit(lambda p, f: jmodel.apply({"params": p}, f, train=False))(
                jstate.params, jb["features"])
            jloss = make_loss_fn(jcfg, jmodel)
            grads = jax.jit(jax.grad(lambda p: jloss(p, jb, jax.random.PRNGKey(1), True)[0]))(
                jstate.params)
            params = params_from_jax(jax.tree.map(np.array, jstate.params))
            jstate2, jm = make_train_step(jcfg)(jstate, jb)  # donates jstate
        _JAX_RUNS[key] = dict(
            batch=batch, params=params, logits=np.asarray(logits),
            grads=params_from_jax(jax.tree.map(np.array, grads)),
            loss=float(jm["loss"]), grad_norm=float(jm["grad_norm"]),
            params2=params_from_jax(jax.tree.map(np.array, jstate2.params)),
        )
    return _JAX_RUNS[key]


@pytest.mark.parametrize(
    "op_variant,dense_variant,use_pallas",
    list(itertools.product(("fused", "fusedchain", "stacked"), ("pallas", "auto"), (False, True))),
)
def test_slice_matches_jax(op_variant, dense_variant, use_pallas):
    """Logits, the loss's gradients and one train step against the JAX
    package on bridged weights."""
    over = {"model.op_variant": op_variant, "model.dense_variant": dense_variant,
            "model.use_pallas": use_pallas}
    _, tcfg = _cfgs(**over)
    pallas_dense = use_pallas or dense_variant == "pallas"
    ref = _jax_run(pallas_dense, use_pallas)
    batch = ref["batch"]

    # the routing the config names
    state = create_train_state(tcfg, device="cpu", params=ref["params"])
    model = state.model
    assert model.dense_scheme == ("fast10" if pallas_dense else "fast8")
    if use_pallas:
        assert model.conv_scheme is None and not any(model.stacked)
        assert [model.qconv_0.im2col, model.qconv_1.im2col, model.qconv_2.im2col] == [False, True, True]
    else:
        assert model.conv_scheme == "fast10" and model.stacked == [False, True, True]

    model.eval()
    with torch.no_grad():
        got_logits = model(torch.from_numpy(batch["features"]))
    np.testing.assert_allclose(got_logits.numpy(), ref["logits"], rtol=1e-4, atol=1e-4)

    model.train()
    b = batch_to_device(batch, torch.device("cpu"))
    loss = loss_fn(tcfg, model(b["features"], lengths=b["feature_lengths"],
                               generator=state.generator), b)
    loss.backward()
    for k, p in model.named_parameters():
        _close_rel(p.grad, ref["grads"][k].numpy(), f"grad {k}")
    state.optimizer.zero_grad(set_to_none=True)

    m = train_step(state, batch)
    np.testing.assert_allclose(m["loss"].item(), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), ref["grad_norm"], rtol=1e-5)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref["params2"][k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_qlstm_use_pallas_matches_jax():
    """A small QCNN-LSTM under ``use_pallas``: the tower packed (the im2col
    GEMM for its wide layers) and the dense layer on the 10-product GEMM,
    as the JAX encoder passes the flag to both; logits against JAX's."""
    # pins the routing alone: qconv_1's Cin * kh * kw = 72 >= 32 takes the
    # im2col GEMM, qconv_0's 9 does not; one layer of the smallest hidden size
    over = {
        "model.conv_features": (8, 16), "model.lstm_features": 8, "model.lstm_layers": 1,
        "model.dense_features": (8,), "model.vocab": 12, "model.compute_dtype": "float32",
        "model.use_pallas": True, "data.n_mels": 8,
    }
    jcfg = jget_config("librispeech_qlstm").override(**over)
    tcfg = get_config("librispeech_qlstm").override(**over)
    x = np.random.default_rng(3).standard_normal((2, 21, 8, 4)).astype(np.float32)
    lengths = np.array([21, 13], np.int32)
    jmodel = jbuild_model(jcfg)
    with hlo_interpret():
        tree = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        want = jax.jit(lambda p, xx, ll: jmodel.apply({"params": p}, xx, train=False, lengths=ll))(
            tree, jnp.asarray(x), jnp.asarray(lengths))
    port = build_model(tcfg, device="cpu")
    assert not any(port.stacked) and port.qconv_1.im2col and not port.qconv_0.im2col
    assert port.qdense_0.scheme == "fast10"
    port.load_state_dict(params_from_jax(jax.tree.map(np.array, tree)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the routing table (build_model's docstring)
# ---------------------------------------------------------------------------

_QCNN_ROUTES = {  # op_variant -> the stacked layers' scheme (None: all packed)
    "auto": "fast8", "stacked8": "fast8", "fused8": "fast8", "fusedchain8": "fast8",
    "stacked8g": "fast8", "stacked": "fast10", "fused": "fast10", "fusedchain": "fast10",
    "block": None,
}
_DENSE_ROUTES = {
    "pallas": "fast10", "fast": "fast10", "auto": "fast8", "block": "fast8", "fast8": "fast8",
    "pallas8": "fast8", "fast8_stacked": "fast8",
}
_SMALL = {"model.conv_features": (8, 16), "model.dense_features": (8,), "data.n_mels": 8}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_qcnn_routing_table(train, use_pallas):
    """Every op_variant and dense_variant the JAX package takes builds as
    the table says (the packed XLA arms every layer packed on their arm;
    legacy_auto on the block path below 128 channels); an unknown value
    raises ValueError. Train and eval mode alike."""
    base = get_config("tiny_synthetic").override(**_SMALL, **{"model.use_pallas": use_pallas})
    for ov, scheme in _QCNN_ROUTES.items():
        for dv, dscheme in _DENSE_ROUTES.items():
            m = build_model(base.override(**{"model.op_variant": ov, "model.dense_variant": dv}),
                            device="cpu", train=train)
            assert m.training == train
            want_scheme = None if use_pallas else scheme
            assert m.conv_scheme == want_scheme, (ov, dv)
            assert m.stacked == [False, want_scheme is not None], (ov, dv)
            if want_scheme is not None:
                assert m.qconv_1.scheme == want_scheme
            assert [m.qconv_0.im2col, m.qconv_1.im2col] == [False, use_pallas]
            assert m.qdense_0.scheme == ("fast10" if use_pallas else dscheme), (ov, dv)
    for ov in ("fast", "fast10", "fast8", "legacy_auto"):
        m = build_model(base.override(**{"model.op_variant": ov}), device="cpu", train=train)
        assert m.conv_scheme is None and m.stacked == [False, False], ov
        arm = "block" if ov == "legacy_auto" else ov
        assert [m.qconv_0.arm, m.qconv_1.arm] == [arm, arm], ov
        assert [m.qconv_0.im2col, m.qconv_1.im2col] == [False, use_pallas]
    with pytest.raises(ValueError, match="unknown op_variant"):
        build_model(base.override(**{"model.op_variant": "fused9"}), device="cpu", train=train)
    with pytest.raises(ValueError, match="unknown dense_variant"):
        build_model(base.override(**{"model.dense_variant": "pallas9"}), device="cpu", train=train)


@pytest.mark.parametrize("train", [False, True])
def test_qlstm_routing_table(train):
    """qlstm: op_variant routes the recurrence (qlstm_routing), use_pallas
    the tower and the dense layers, dense_variant is read by neither
    package; unknown values raise ValueError."""
    base = get_config("librispeech_qlstm").override(**{
        "model.conv_features": (8, 16), "model.lstm_features": 8, "model.lstm_layers": 1,
        "model.dense_features": (8,), "model.compute_dtype": "float32", "data.n_mels": 8,
    })
    for use_pallas in (False, True):
        for dv in _DENSE_ROUTES:
            cfg = base.override(**{"model.use_pallas": use_pallas, "model.dense_variant": dv})
            m = build_model(cfg, device="cpu", train=train)
            assert m.training == train and m.recurrent == qlstm_routing(cfg.model, "cpu")[1]
            assert m.conv_scheme == (None if use_pallas else "fast8")
            assert m.qconv_1.im2col == use_pallas
            assert m.qdense_0.scheme == ("fast10" if use_pallas else "fast8")
    with pytest.raises(ValueError, match="unknown dense_variant"):
        build_model(base.override(**{"model.dense_variant": "pallas9"}), device="cpu", train=train)
    block = build_model(base.override(**{"model.op_variant": "block"}), device="cpu", train=train)
    assert block.training == train and block.recurrent == "block"
    assert block.qbilstm_0.input_proj == "block"
    with pytest.raises(ValueError, match="not valid"):
        build_model(base.override(**{"model.op_variant": "fused"}), device="cpu", train=train)
