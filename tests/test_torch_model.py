"""The qasr_torch serving slice as a whole, against the JAX package.

A small qcnn config (conv (8, 16, 16), dense (16,), 8 mels, f32) is built
and initialised by the JAX package from a seed; its params are exported to
numpy, bridged and loaded into the port. On the CPU the port runs the
kernels' plain versions, and routes the post-pool layers through the stacked
rank-8 path (kernel A's plain version) while JAX's ``op_variant="auto"``
keeps them on the block path at these widths, so the two sides compute the
same function along different routes.

Tolerances: logits rtol/atol 1e-4 (f32 sums in another order and through
another bilinear scheme); decoded ids compared exactly on frames whose JAX
top-2 margin exceeds twice the logits tolerance, where no logit error within
it can change the argmax.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from qasr.configs import get_config
from qasr.data.timit import ID_TO_PHONE
from qasr.decode import ctc_beam_search_decode
from qasr.features import FrontendConfig as JFrontendConfig
from qasr.features import featurize_waveform as jfeaturize
from qasr.native import ctc_beam_decode_native, edit_distance_native
from qasr.ops.ctc import ctc_greedy_decode as jgreedy
from qasr.train.state import build_model as jbuild_model
from qasr_torch import native as tnative
from qasr_torch.bridge import load_params_npz, params_from_jax, save_params_npz
from qasr_torch.infer import Transcriber
from qasr_torch.models import build_model
from qasr_torch.ops.ctc import ctc_greedy_decode, log_softmax_f32
from qasr_torch.ops.initializers import quaternion_init

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
OUTPUT_SCALE = 20.0

CFG = get_config("timit_qcnn").override(
    **{
        "model.conv_features": (8, 16, 16),
        "model.dense_features": (16,),
        "model.compute_dtype": "float32",
        "data.n_mels": 8,
        "data.bucket_sizes": (64, 128),
        "decode.beam_width": 16,
    }
)


@pytest.fixture(scope="module")
def jax_side():
    model = jbuild_model(CFG)
    x = jnp.zeros((1, 64, CFG.data.n_mels, 4), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)["params"]
    # A fresh init gives near-flat logits; scaling the output layer spreads
    # them as a trained model's are, so most frames have a clear argmax.
    params = dict(params)
    params["output"] = jax.tree.map(lambda a: a * OUTPUT_SCALE, params["output"])
    return model, params, jax.tree.map(np.asarray, params)


def _wavs(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in (5200, 9001, 12345):
        env = np.abs(np.sin(np.linspace(0, 4 * np.pi, n)))
        out.append((0.1 * env * rng.standard_normal(n)).astype(np.float32))
    return out


def _jax_logits(model, params, wavs):
    fcfg = JFrontendConfig(sample_rate=CFG.data.sample_rate, n_mels=CFG.data.n_mels)
    feats = [jfeaturize(w, fcfg) for w in wavs]
    lengths = np.array([f.shape[0] for f in feats], np.int32)
    t_pad = 128 if lengths.max() > 64 else 64
    batch = np.zeros((len(feats), t_pad, CFG.data.n_mels, 4), np.float32)
    for i, f in enumerate(feats):
        batch[i, : len(f)] = f
    logits = jax.jit(lambda p, b: model.apply({"params": p}, b, train=False))(
        params, jnp.asarray(batch))
    return np.asarray(logits), lengths


def test_bridge_maps_every_param_one_to_one(jax_side, tmp_path):
    _, _, tree = jax_side
    sd = params_from_jax(tree)
    port = build_model(CFG, device="cpu").state_dict()
    assert set(sd) == set(port)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(sd)
    path = str(tmp_path / "params.npz")
    save_params_npz(sd, path)
    with np.load(path) as z:
        assert set(z.files) == {k.replace(".", "/") for k in sd}
    back = load_params_npz(path)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == torch.float32
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def test_encoder_logits_match_jax(jax_side):
    model, params, tree = jax_side
    port = build_model(CFG, device="cpu")
    port.load_state_dict(params_from_jax(tree))
    assert port.stacked == [False, True, True]
    x = np.random.default_rng(1).standard_normal((2, 37, CFG.data.n_mels, 4)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, xx: model.apply({"params": p}, xx, train=False))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        plain = port(torch.from_numpy(x), plain=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_encoder_with_chain_exit_matches_jax():
    """A thin layer after a stacked one (12 channels: not a multiple of 8)
    sends the tower back to the packed layout, with the pending PReLU."""
    cfg = CFG.override(**{"model.conv_features": (8, 16, 12), "model.dense_features": (8, 8)})
    model = jbuild_model(cfg)
    x = np.random.default_rng(2).standard_normal((2, 21, cfg.data.n_mels, 4)).astype(np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jax.jit(lambda p, xx: model.apply({"params": p}, xx, train=False))(
        params, jnp.asarray(x)))
    port = build_model(cfg, device="cpu")
    assert port.stacked == [False, True, False]
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_transcriber_greedy_matches_jax_pipeline(jax_side, tmp_path):
    model, params, tree = jax_side
    wavs = _wavs()
    want_logits, lengths = _jax_logits(model, params, wavs)
    # the checkpoint-directory form: config.json + params.npz
    (tmp_path / "config.json").write_text(CFG.to_json())
    save_params_npz(params_from_jax(tree), str(tmp_path / "params.npz"))
    tr = Transcriber(str(tmp_path), device="cpu")
    got_logits, got_lengths = tr.logits(wavs)
    np.testing.assert_array_equal(got_lengths.numpy(), lengths)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, **TOL)

    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    tol = TOL["atol"] + TOL["rtol"] * np.abs(want_logits).max()
    valid = np.arange(want_logits.shape[1])[None] < lengths[:, None]
    clear = valid & (margin > 2 * tol)
    assert clear.sum() >= 0.9 * valid.sum()
    np.testing.assert_array_equal(
        got_logits.numpy().argmax(-1)[clear], want_logits.argmax(-1)[clear]
    )
    seq, lens = jgreedy(jnp.asarray(want_logits), jnp.asarray(lengths))
    seq, lens = np.asarray(seq), np.asarray(lens)
    want = [[ID_TO_PHONE[int(i)] for i in seq[b, : lens[b]]] for b in range(len(wavs))]
    got = tr.transcribe_batch(wavs)
    for b in range(len(wavs)):
        if clear[b, : lengths[b]].all():
            assert got[b] == want[b]
    assert any(clear[b, : lengths[b]].all() for b in range(len(wavs)))


def test_log_softmax_f32_matches_jax():
    logits = np.random.default_rng(4).standard_normal((2, 5, 62)).astype(np.float32) * 5
    want = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    got = log_softmax_f32(torch.from_numpy(logits).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        log_softmax_f32(torch.from_numpy(logits)).numpy(), want, rtol=1e-5, atol=1e-5
    )


def test_ctc_greedy_decode_matches_jax():
    rng = np.random.default_rng(3)
    # few classes so that repeats and blanks are frequent
    logits = rng.standard_normal((4, 40, 4)).astype(np.float32)
    lengths = np.array([40, 17, 1, 0], np.int32)
    want_seq, want_len = jgreedy(jnp.asarray(logits), jnp.asarray(lengths))
    seq, lens = ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(lengths))
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_len))


def test_beam_native_matches_jax_beam(jax_side):
    """The port's beam (``Transcriber(beam=True)``: the on-device
    ``qasr_torch.decode.beam``, on the CPU here) on the port's logits equals
    qasr.decode.ctc_beam_search_decode and the JAX package's native host
    beam on the same logits, at the config's width and its absolute -20
    pruning."""
    _, _, tree = jax_side
    tr = Transcriber(cfg=CFG, params=tree, beam=True, device="cpu")
    wavs = _wavs(seed=5)
    logits, lengths = tr.logits(wavs)
    seq, lens = tr.decode(logits, lengths)
    want_seq, want_len, _ = ctc_beam_search_decode(
        jnp.asarray(logits.numpy()),
        jnp.asarray(lengths.numpy()),
        beam_width=CFG.decode.beam_width,
        max_len=logits.shape[1],
        prune_logp=CFG.decode.beam_prune_logp,
    )
    np.testing.assert_array_equal(lens, np.asarray(want_len))
    np.testing.assert_array_equal(seq, np.asarray(want_seq))
    n_seq, n_len, _ = ctc_beam_decode_native(
        logits.numpy(), lengths.numpy(), beam_width=CFG.decode.beam_width,
        max_len=logits.shape[1], prune_logp=CFG.decode.beam_prune_logp,
    )
    np.testing.assert_array_equal(seq, n_seq)
    phones = tr.transcribe_batch(wavs)
    assert [len(p) for p in phones] == [int(n) for n in lens]


def test_native_copies_match_reference_on_served_logits(jax_side):
    """The port's native beam and edit distance, built from its own copy of
    the sources, give the reference library's outputs on the logits of
    test_beam_native_matches_jax_beam."""
    _, _, tree = jax_side
    tr = Transcriber(cfg=CFG, params=tree, beam=True, device="cpu")
    logits, lengths = tr.logits(_wavs(seed=5))
    kw = dict(beam_width=CFG.decode.beam_width, max_len=logits.shape[1],
              prune_logp=CFG.decode.beam_prune_logp)
    got = tnative.ctc_beam_decode_native(logits.numpy(), lengths.numpy(), **kw)
    want = ctc_beam_decode_native(logits.numpy(), lengths.numpy(), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    greedy, glens = ctc_greedy_decode(logits, lengths)
    seqs, lens = got[0], got[1]
    for b in range(len(lens)):
        ref, hyp = seqs[b, : lens[b]].tolist(), greedy[b, : glens[b]].tolist()
        assert tnative.edit_distance_native(ref, hyp) == edit_distance_native(ref, hyp)


def test_build_model_other_archs_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 13"):
        build_model(CFG.override(**{"model.arch": "real_lstm"}), device="cpu")
    with pytest.raises(ValueError, match="unknown arch"):
        build_model(CFG.override(**{"model.arch": "transformer"}), device="cpu")
    # the real-CNN baseline (config 3) is ported: tests/test_torch_real_cnn.py
    assert type(build_model(CFG.override(**{"model.arch": "real_cnn"}), device="cpu")).__name__ \
        == "RealCNNEncoder"
    # qlstm serves and trains; its block recurrence is not ported yet
    for over in ({"model.op_variant": "block"}, {"model.op_variant": "fast8"}):
        for train in (False, True):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                build_model(CFG.override(**{"model.arch": "qlstm", **over}), device="cpu",
                            train=train)
    model = build_model(CFG.override(**{"model.arch": "qlstm"}), device="cpu", train=True)
    assert model.training and model.recurrent == "fast8"


class TestInit:
    """Chi(4) init, by distribution (torch.Generator is not JAX's PRNG)."""

    def test_magnitude_is_chi4(self):
        g = torch.Generator().manual_seed(2)
        w = quaternion_init((4, 200, 200), generator=g).numpy()
        mag = np.sqrt((w**2).sum(axis=0)).ravel()
        sigma = 1.0 / math.sqrt(2 * (200 + 200))
        _, p = stats.kstest(mag / sigma, "chi", args=(4,))
        assert p > 1e-3

    def test_angles(self):
        g = torch.Generator().manual_seed(3)
        w = quaternion_init((4, 150, 150), generator=g).numpy().reshape(4, -1)
        mag = np.sqrt((w**2).sum(axis=0))
        # theta ~ U(-pi, pi): cos(theta) = w_r / |w| has CDF 1 - arccos(c)/pi
        _, p = stats.kstest(w[0] / mag, lambda c: 1.0 - np.arccos(np.clip(c, -1, 1)) / np.pi)
        assert p > 1e-3
        # axis uniform on S^2: each coordinate is U(-1, 1) (Archimedes)
        imag = w[1:] / np.sqrt((w[1:] ** 2).sum(axis=0))
        for c in range(3):
            _, p = stats.kstest(imag[c], "uniform", args=(-1, 2))
            assert p > 1e-3

    def test_variances_and_criteria(self):
        g = torch.Generator().manual_seed(4)
        w = quaternion_init((4, 3, 3, 64, 64), generator=g).numpy()
        sigma2 = 1.0 / (2 * (9 * 64 + 9 * 64))
        np.testing.assert_allclose(np.var(w), sigma2, rtol=0.05)
        np.testing.assert_allclose(np.var(w[0]), 2 * sigma2, rtol=0.08)
        he = quaternion_init((4, 3, 3, 32, 64), generator=g, criterion="he").numpy()
        np.testing.assert_allclose(np.var(he), 1.0 / (2 * 9 * 32), rtol=0.05)
        with pytest.raises(ValueError):
            quaternion_init((3, 4, 4))
