"""The qasr_torch QLSTM training slice (config 4's train step) against the JAX
package.

Inputs come from numpy with a seed; weights are drawn by the JAX package and
bridged into the port. On the CPU the port runs kernel E's plain version
(``qlstm_scan_bwd_plain``, the step-by-step twin of ``_bwd_xla``) under
``QLstmScanFn``, and kernel D's and B's plain versions. Where the JAX side
reaches the Pallas kernels it runs them in interpret mode (``FORCE_KERNEL``
and ``pltpu.force_tpu_interpret_mode()``, as tests/test_qlstm.py does), at
H=128, the kernels' lane rule.

Tolerances, f32: 1e-5 against ``_bwd_xla`` and the dW einsums (sums in
another order; the measured worst is ~3e-7); 2e-4 against the interpreted
Pallas kernels, as the JAX package's own gradient test; 1e-4 for a layer's
or an encoder's parameter gradients (a few f32 layers deep); the train
step's loss and grad norm 1e-5, as tests/test_torch_train.py holds them,
and its params atol 5e-5 (an Adam update moves a weight by up to lr =
3e-3 whatever its gradient's size, so where a gradient is near zero the
~1e-6 relative sum-order difference of the recurrences' f32 gradients moves
the update; measured worst 1.25e-5 after three steps). bf16 storage: see
each test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from qasr.configs import get_config as jget_config
from qasr.data.batching import BatchStream as JBatchStream
from qasr.data.synthetic import SyntheticDataset as JSyntheticDataset
from qasr.models import qlstm as jqlstm
from qasr.ops.ctc import ctc_loss as jctc_loss
from qasr.ops.pallas import qlstm_scan as jscan
from qasr.train.state import build_model as jbuild_model
from qasr.train.state import create_train_state as jcreate_train_state
from qasr.train.step import make_eval_step, make_train_step
from qasr_torch.bridge import params_from_jax
from qasr_torch.configs import get_config
from qasr_torch.infer import Transcriber
from qasr_torch.models import build_model
from qasr_torch.models.qlstm import QBiLSTM, QLSTMEncoder
from qasr_torch.ops.kernels import qlstm_scan
from qasr_torch.train.loop import train
from qasr_torch.train.state import create_train_state
from qasr_torch.train.step import batch_to_device, eval_step, loss_fn, train_step

torch.set_num_threads(1)
TOL_XLA = dict(rtol=1e-5, atol=1e-5)
TOL_KERNEL = dict(rtol=2e-4, atol=2e-4)
TOL_GRAD = dict(rtol=1e-4, atol=1e-4)
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

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


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _scan_residuals(t, b, hid, seed):
    """What the forward saves and the backward reads, drawn from numpy: gates
    (sigmoids in (0, 1), tanh in (-1, 1)), cs, hs, signed dhs, wc8, ragged
    lengths."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    gates = np.concatenate([1 / (1 + np.exp(-rnd(t, 2, b, 12 * hid))),
                            np.tanh(rnd(t, 2, b, 4 * hid))], axis=-1).astype(np.float32)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[0] = t
    return dict(wc8=rnd(2, 8, hid, 4 * hid, scale=hid ** -0.5), gates=gates,
                cs=rnd(t, 2, b, 4 * hid, scale=0.5), hs=np.tanh(rnd(t, 2, b, 4 * hid)),
                dhs=rnd(t, 2, b, 4 * hid), lengths=lengths)


def _jax_mask(t, b, lengths, jdt):
    mask = qlstm_scan.activity_mask(t, 2, _t(lengths), b, "cpu").numpy()
    return jnp.broadcast_to(jnp.asarray(mask)[..., None], (t, 2, b, 128)).astype(jdt)


def _as(a, dtype):
    """numpy f32 -> a tensor in ``dtype`` and the same values in JAX."""
    x = _t(a).to(dtype)
    return x, jnp.asarray(x.float().numpy()).astype(_JDT[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_plain_matches_bwd_xla(dtype):
    """dz of the plain backward against ``_bwd_xla`` at H=16, ragged lengths,
    signed dhs.

    bf16: both carry dh and dc in f32, round dprods (formed from the f32 dz)
    and dz once, at the same places; only the order of the f32 product sums
    may differ, so nearly every value is equal (measured: all). The negative
    control runs the same backward in f32 and rounds dz at the end (dprods
    never rounded): 88% equal, rel-norm 1.5e-3. So the limits (99% equal,
    rel-norm 1e-4) pin the rounding points."""
    t, b, hid = 20, 3, 16
    r = _scan_residuals(t, b, hid, seed=1)
    (wc8, jwc8), (gates, jgates), (cs, jcs), (dhs, jdhs) = (
        _as(r[k], dtype) for k in ("wc8", "gates", "cs", "dhs"))
    jcp = jnp.concatenate([jnp.zeros_like(jcs[:1]), jcs[:-1]])
    want = jscan._bwd_xla(jnp.swapaxes(jwc8, 2, 3), jgates, jcp, jdhs,
                          _jax_mask(t, b, r["lengths"], _JDT[dtype]))
    want = np.asarray(want.astype(jnp.float32))
    lengths = _t(r["lengths"])
    got = qlstm_scan.qlstm_scan_bwd_plain(wc8, gates, cs, dhs, lengths)
    assert got.dtype == dtype and got.shape == gates.shape
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL_XLA)
        return
    assert (got == want).mean() >= 0.99
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4
    ctl = qlstm_scan.qlstm_scan_bwd_plain(wc8.float(), gates.float(), cs.float(), dhs.float(),
                                          lengths).to(dtype).float().numpy()
    assert (ctl == want).mean() < 0.99
    assert np.linalg.norm(ctl - want) / np.linalg.norm(want) > 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_matches_scan_core_bwd(dtype):
    """``qlstm_scan_dw`` against the dW of ``_scan_core_bwd`` (and the plain
    backward's dz against its dz) on the same residuals, H=16.

    bf16: the V8 combos of h_prev and the O8 combos of dz are bf16 einsums,
    the products sum in f32 and dW is rounded once to bf16; on the same dz
    the port rounds at the same places, so only the f32 sum order differs
    and a value rounds to the neighbouring bf16 number now and then
    (measured: 99.99% equal, rel-norm 6e-7; limits 99% and 1e-4). The
    negative control forms the combos in f32 (rel-norm 3.8e-3)."""
    t, b, hid = 12, 3, 16
    r = _scan_residuals(t, b, hid, seed=2)
    (wc8, jwc8), (gates, jgates), (cs, jcs), (dhs, jdhs), (hs, jhs) = (
        _as(r[k], dtype) for k in ("wc8", "gates", "cs", "dhs", "hs"))
    res = (jwc8, _jax_mask(t, b, r["lengths"], _JDT[dtype]), jhs, jcs, jgates)
    jdz, jdw, _ = jscan._scan_core_bwd(res, jdhs)
    assert jdw.dtype == _JDT[dtype]
    dz = qlstm_scan.qlstm_scan_bwd_plain(wc8, gates, cs, dhs, _t(r["lengths"]))
    want_dz = np.asarray(jdz.astype(jnp.float32))
    want = np.asarray(jdw.astype(jnp.float32))
    # dW from JAX's own dz, so that only the dW einsums are compared
    dz_j = _t(want_dz).to(dtype)
    got = qlstm_scan.qlstm_scan_dw(hs, dz_j)
    assert got.dtype == dtype and got.shape == wc8.shape
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(dz.numpy(), want_dz, **TOL_XLA)
        np.testing.assert_allclose(got, want, **TOL_XLA)
        return
    assert np.linalg.norm(dz.float().numpy() - want_dz) / np.linalg.norm(want_dz) <= 1e-4
    assert (got == want).mean() >= 0.99
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4
    ctl = qlstm_scan.qlstm_scan_dw(hs.float(), dz_j.float()).to(dtype).float().numpy()
    assert np.linalg.norm(ctl - want) / np.linalg.norm(want) > 1e-4


def test_scan_grads_match_pallas_kernels_interpret(monkeypatch):
    """The port's ``qlstm_scan_fast8`` under autograd (``QLstmScanFn`` on the
    CPU: the plain forward and backward, then the dW einsums) against
    ``jax.vjp`` of the JAX op through both interpreted Pallas kernels: hs,
    dxz and dwc8, at H=128, ragged lengths, a numpy cotangent."""
    monkeypatch.setattr(jscan, "FORCE_KERNEL", True)
    b, t, hid = 3, 14, 128
    rng = np.random.default_rng(3)
    xz = (rng.standard_normal((t, 2, b, 16 * hid)) * 0.5).astype(np.float32)
    wc8 = (rng.standard_normal((2, 8, hid, 4 * hid)) / np.sqrt(hid)).astype(np.float32)
    cot = rng.standard_normal((t, 2, b, 4 * hid)).astype(np.float32)
    lengths = np.array([14, 9, 4], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a, w: jscan.qlstm_scan_fast8(a, w, jnp.asarray(lengths)),
                            jnp.asarray(xz), jnp.asarray(wc8))
        want_dxz, want_dwc8 = vjp(jnp.asarray(cot))
    x_t, w_t = _t(xz).requires_grad_(), _t(wc8).requires_grad_()
    launches = (qlstm_scan.qlstm_scan_fast8.launches, qlstm_scan.qlstm_scan_bwd.launches)
    hs = qlstm_scan.qlstm_scan_fast8(x_t, w_t, _t(lengths))
    assert type(hs.grad_fn).__name__ == "QLstmScanFnBackward"
    hs.backward(_t(cot))
    # the CPU runs no kernel
    assert (qlstm_scan.qlstm_scan_fast8.launches, qlstm_scan.qlstm_scan_bwd.launches) == launches
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(want), **TOL_KERNEL)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(want_dxz), **TOL_KERNEL)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(want_dwc8), **TOL_KERNEL)


def test_function_is_used_on_both_paths_under_grad():
    """Under grad the forward goes through QLstmScanFn with plain=True too
    (autograd through the plain loop would give another bf16 gradient);
    without grad it does not build a graph."""
    r = _scan_residuals(5, 2, 16, seed=4)
    xz = _t(np.random.default_rng(5).standard_normal((5, 2, 2, 256)).astype(np.float32))
    wc8 = _t(r["wc8"]).requires_grad_()
    for plain in (False, True):
        hs, cs, gates = qlstm_scan.qlstm_scan_fwd(xz, wc8, _t(r["lengths"]), plain=plain)
        assert type(hs.grad_fn).__name__ == "QLstmScanFnBackward"
        assert not cs.requires_grad and not gates.requires_grad
    with torch.no_grad():
        hs, _, _ = qlstm_scan.qlstm_scan_fwd(xz, wc8, _t(r["lengths"]))
    assert hs.grad_fn is None


def _random_biases(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        if str(path[-1].key) == "bias" else np.asarray(a),
        tree,
    )


def _port_grads(module):
    return {k: p.grad.numpy() for k, p in module.named_parameters()}


@pytest.mark.parametrize("recurrent,hid", [("pallas8", 128), ("fast8", 16)])
def test_qbilstm_param_grads_match_jax(recurrent, hid):
    """Every parameter's gradient, and the input's, of one QBiLSTM with
    ragged lengths against ``jax.grad`` of the JAX layer on bridged weights:
    pallas8 through QLstmScanFn (JAX: its custom VJP with the XLA twins),
    fast8 through autograd (JAX differentiates its scan)."""
    b, t, cin = 3, 11, 8
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((b, t, 4 * cin)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((b, t, 8 * hid)).astype(np.float32)
    lengths = np.array([11, 6, 2], np.int32)
    ref = jqlstm.QBiLSTM(hidden=hid, recurrent=recurrent)
    params = ref.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(lengths))["params"]
    params = _random_biases(params, seed=7)

    def jloss(p, xx):
        return jnp.sum(ref.apply({"params": p}, xx, jnp.asarray(lengths)) * cot)

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    port = QBiLSTM(cin, hid, recurrent=recurrent, device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    xt = _t(x).requires_grad_()
    (port(xt, _t(lengths)) * _t(cot)).sum().backward()
    want = params_from_jax(jax.tree.map(np.asarray, want_p))
    got = _port_grads(port)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k, **TOL_GRAD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL_GRAD)


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


@pytest.mark.parametrize("recurrent", ["fast8", "pallas8"])
def test_encoder_param_grads_match_jax(qlstm_batches, recurrent):
    """The whole encoder's loss gradients on a ragged batch against the JAX
    encoder's (its fast8 recurrence, as JAX routes it off the TPU): the port
    on fast8 (autograd) and on pallas8 (QLstmScanFn with the plain versions),
    which in f32 compute the same function."""
    jcfg, tcfg = _cfgs()
    batch = qlstm_batches[0]
    jmodel = jbuild_model(jcfg)
    assert jmodel.recurrent == "fast8"
    tree = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["features"]))["params"]
    tree = _random_biases(jax.tree.map(np.asarray, tree), seed=8)
    jb = _jbatch(batch)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jb["features"], train=False,
                              lengths=jb["feature_lengths"])
        losses = jctc_loss(logits, jb["labels"], jb["feature_lengths"], jb["label_lengths"])
        return (losses * jb["real_rows"]).sum() / jnp.maximum(
            (jb["label_lengths"] * jb["real_rows"]).sum(), 1)

    want_loss, want_g = jax.value_and_grad(jloss)(tree)
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
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, want_g))
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
    jstate = jcreate_train_state(jcfg, jax.random.PRNGKey(0), batches[0]["features"])
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
