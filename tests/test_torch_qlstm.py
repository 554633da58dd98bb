"""The qasr_torch QLSTM slice (config 4's serving path) against the JAX package.

Inputs come from numpy with a seed; weights are drawn by the JAX package and
bridged into the port. On the CPU the port runs kernel D's plain version
(``qlstm_scan_fwd_plain``, the step-by-step twin of ``_fwd_xla``) and kernel
B's. Where the JAX side reaches the Pallas kernel it runs interpreted
(``FORCE_KERNEL``, as tests/test_qlstm.py does, under
``tests/pallas_interpret.py:hlo_interpret``), at H=128, the kernel's lane
rule.

Tolerances, f32: 2e-5 against the interpreted Pallas kernel (as the JAX
package's own test); 1e-5 against ``_fwd_xla``, whose products sum in
another order (the measured worst is ~2e-7); 1e-4 for whole encoders, as for
the QCNN. bf16 storage: see ``test_scan_plain_matches_fwd_xla``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.configs import get_config
from qasr.models import qlstm as jqlstm
from qasr.ops.pallas import qlstm_scan as jscan
from qasr.train.state import build_model as jbuild_model
from qasr_torch.bridge import params_from_jax
from qasr_torch.infer import Transcriber
from qasr_torch.models import build_model, qlstm_routing
from qasr_torch.models.qlstm import (
    BLOCK_ROWS,
    QBiLSTM,
    QLSTMEncoder,
    input_proj_fn,
    qchannel_concat,
    qchannel_split,
)
from qasr_torch.ops.kernels import qlstm_scan
from qasr_torch.ops.kernels.qgemm8 import qdense_pallas8
from tests.pallas_interpret import hlo_interpret

torch.set_num_threads(1)
TOL_KERNEL = dict(rtol=2e-5, atol=2e-5)
TOL_XLA = dict(rtol=1e-5, atol=1e-5)
TOL_ENC = dict(rtol=1e-4, atol=1e-4)

CFG = get_config("librispeech_qlstm").override(
    **{
        "model.conv_features": (8, 8, 16, 16),
        "model.lstm_features": 16,
        "model.lstm_layers": 2,
        "model.vocab": 12,
        "model.compute_dtype": "float32",
        "data.n_mels": 8,
        "data.bucket_sizes": (64, 128),
        "decode.beam_width": 4,
    }
)


@pytest.fixture
def force_pallas(monkeypatch):
    # off-TPU the JAX op routes to its XLA twin; force the kernel, interpreted
    monkeypatch.setattr(jscan, "FORCE_KERNEL", True)


def _scan_inputs(t, b, hid, seed=0):
    rng = np.random.default_rng(seed)
    xz = (rng.standard_normal((t, 2, b, 16 * hid)) * 0.5).astype(np.float32)
    wc8 = (rng.standard_normal((2, 8, hid, 4 * hid)) / np.sqrt(hid)).astype(np.float32)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[0] = t
    return xz, wc8, lengths


@pytest.mark.parametrize("use_lengths", [True, False])
@pytest.mark.parametrize("b,t", [(2, 16), (3, 17), (1, 5)])
def test_scan_matches_pallas_kernel_interpret(force_pallas, b, t, use_lengths):
    xz, wc8, lengths = _scan_inputs(t, b, 128, seed=b * 100 + t)
    if not use_lengths:
        lengths = None
    with hlo_interpret():
        want = jscan.qlstm_scan_fast8(
            jnp.asarray(xz), jnp.asarray(wc8), None if lengths is None else jnp.asarray(lengths)
        )
    before = qlstm_scan.qlstm_scan_fast8.launches
    got = qlstm_scan.qlstm_scan_fast8(
        torch.from_numpy(xz), torch.from_numpy(wc8),
        None if lengths is None else torch.from_numpy(lengths),
    )
    assert qlstm_scan.qlstm_scan_fast8.launches == before  # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_KERNEL)


def _fwd_xla(xz_gm, wc8, mask, dtype):
    t, d, b, _ = xz_gm.shape
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    m = jnp.broadcast_to(jnp.asarray(mask)[..., None], (t, d, b, 128)).astype(jdt)
    outs = jscan._fwd_xla(jnp.asarray(xz_gm).astype(jdt), jnp.asarray(wc8).astype(jdt), m)
    return [np.asarray(o.astype(jnp.float32)) for o in outs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_plain_matches_fwd_xla(dtype):
    """hs, cs and gates of the plain version against ``_fwd_xla`` at H=16.

    bf16: both carry h and c in bf16, rounded every step, and differ only in
    the order of the f32 product sums, so a value rounds to the other
    neighbouring bf16 number only now and then: at least 95% of the values
    are equal and the rel-norm is at most 1e-3. A carry kept in f32 (the
    outputs rounded to bf16 only at the end) breaks the first limit, which
    the test checks too: the limits pin the rounding of the carry."""
    t, b, hid = 40, 3, 16
    xz, wc8, lengths = _scan_inputs(t, b, hid, seed=1)
    xz_gm = qlstm_scan.to_gate_major(torch.from_numpy(xz)).to(dtype)
    mask = qlstm_scan.activity_mask(t, 2, torch.from_numpy(lengths), b, "cpu").numpy()
    want = _fwd_xla(xz_gm.float().numpy(), wc8, mask, dtype)
    got = qlstm_scan.qlstm_scan_fwd_plain(xz_gm, torch.from_numpy(wc8).to(dtype),
                                          torch.from_numpy(lengths))
    for name, g, w in zip(("hs", "cs", "gates"), got, want):
        assert g.dtype == dtype, name
        g = g.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL_XLA)
        else:
            assert (g == w).mean() >= 0.95, name
            assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-3, name
    if dtype == torch.bfloat16:
        f32_carry = qlstm_scan.qlstm_scan_fwd_plain(
            xz_gm.float(), torch.from_numpy(wc8).to(dtype).float(), torch.from_numpy(lengths))
        hs = f32_carry[0].to(dtype).float().numpy()
        assert (hs == want[0]).mean() < 0.95


def test_activity_mask_and_gate_major_layout():
    # direction 1 walks the flipped stream: it freezes its first T - len steps
    m = qlstm_scan.activity_mask(5, 2, torch.tensor([5, 2]), 2, "cpu")
    np.testing.assert_array_equal(m[:, 0].T.numpy(), [[1, 1, 1, 1, 1], [1, 1, 0, 0, 0]])
    np.testing.assert_array_equal(m[:, 1].T.numpy(), [[1, 1, 1, 1, 1], [0, 0, 0, 1, 1]])
    # [q, g, H] -> [g, q, H], as qlstm_scan.py:773-778
    xz = np.arange(2 * 1 * 1 * 32, dtype=np.float32).reshape(2, 1, 1, 32)
    want = xz.reshape(2, 1, 1, 4, 4, 2).transpose(0, 1, 2, 4, 3, 5).reshape(2, 1, 1, 32)
    np.testing.assert_array_equal(qlstm_scan.to_gate_major(torch.from_numpy(xz)).numpy(), want)


def test_qchannel_split_concat_match_jax():
    x = np.random.default_rng(2).standard_normal((2, 3, 4 * 12)).astype(np.float32)
    want = jqlstm.qchannel_split(jnp.asarray(x), 4)
    got = qchannel_split(torch.from_numpy(x), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(qchannel_concat(got).numpy(), x)


def _random_biases(tree, seed):
    """A fresh init has zero biases; give them values so that their
    placement is tested too."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        if str(path[-1].key) == "bias" else np.asarray(a),
        tree,
    )


@pytest.mark.parametrize("recurrent,hid", [("pallas8", 128), ("fast8", 16)])
def test_qbilstm_matches_jax(force_pallas, recurrent, hid):
    # pallas8 at H=128, the TPU kernel's lane rule (the least it takes);
    # three ragged lengths, one of them the full T
    b, t, cin = 3, 11, 8
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((b, t, 4 * cin)) * 0.5).astype(np.float32)
    lengths = np.array([11, 6, 2], np.int32)
    ref = jqlstm.QBiLSTM(hidden=hid, recurrent=recurrent)
    params = jax.jit(ref.init)(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(lengths))
    params = _random_biases(params["params"], seed=4)
    with hlo_interpret():
        want = jax.jit(lambda p, xx, ll: ref.apply({"params": p}, xx, ll))(
            params, jnp.asarray(x), jnp.asarray(lengths))
    port = QBiLSTM(cin, hid, recurrent=recurrent, device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.shape == (b, t, 4 * 2 * hid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_KERNEL)


@pytest.fixture(scope="module")
def jax_encoder():
    model = jbuild_model(CFG)
    assert model.recurrent == "fast8"  # off the TPU, JAX's auto routing
    x = jnp.zeros((1, 16, CFG.data.n_mels, 4), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)["params"]
    return model, _random_biases(jax.tree.map(np.asarray, params), seed=5)


@pytest.mark.parametrize("recurrent", ["fast8", "pallas8"])
def test_encoder_matches_jax_with_ragged_lengths(jax_encoder, recurrent):
    """The port's encoder on both recurrences (kernel D's plain version for
    pallas8) against JAX's build_model on the CPU (the fast8 recurrence):
    in f32 the two recurrences compute the same function."""
    model, tree = jax_encoder
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 29, CFG.data.n_mels, 4)).astype(np.float32)
    lengths = np.array([29, 17, 5], np.int32)
    want = jax.jit(lambda p, xx, ll: model.apply({"params": p}, xx, train=False, lengths=ll))(
        tree, jnp.asarray(x), jnp.asarray(lengths))
    if recurrent == "fast8":
        port = build_model(CFG, device="cpu")
        assert port.recurrent == "fast8" and not port.training
    else:
        m = CFG.model
        port = QLSTMEncoder(
            n_feats=CFG.data.n_mels, conv_features=m.conv_features,
            dense_features=m.dense_features, lstm_features=m.lstm_features,
            lstm_layers=m.lstm_layers, vocab=m.vocab, recurrent="pallas8", device="cpu",
        ).eval()
    port.load_state_dict(params_from_jax(tree), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_ENC)


def test_bridge_loads_jax_qlstm_tree_strictly(jax_encoder):
    _, tree = jax_encoder
    sd = params_from_jax(tree)
    port = build_model(CFG, device="cpu")
    assert set(sd) == set(port.state_dict())
    assert {"qbilstm_1.bwd_cell.wh", "qdense_0.kernel", "output.bias"} <= set(sd)
    port.load_state_dict(sd, strict=True)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    assert len(jax.tree_util.tree_leaves(tree)) == len(sd)


def _wavs():
    rng = np.random.default_rng(7)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (13000, 4321)]


def test_transcriber_passes_lengths(jax_encoder):
    """A padded batch gives the unpadded utterance's logits on its valid
    frames: the backward direction freezes on the padding. Without the
    lengths the padding leaks into it."""
    _, tree = jax_encoder
    wavs = _wavs()
    for beam in (False, True):
        tr = Transcriber(cfg=CFG, params=tree, beam=beam, device="cpu")
        out = tr.transcribe_batch(wavs)
        assert len(out) == 2 and all(isinstance(s, str) for s in out)
    logits, lengths = tr.logits(wavs)
    assert logits.shape[1] == 128 and lengths.tolist()[1] < 64
    alone, alone_len = tr.logits(wavs[1:])
    assert alone.shape[1] == 64
    n = int(lengths[1])
    torch.testing.assert_close(logits[1, :n], alone[0, :n], rtol=1e-5, atol=1e-5)
    # the negative control: the same padded batch without lengths
    feats_len = int(alone_len[0])
    with torch.no_grad():
        batch = torch.zeros((1, 128, CFG.data.n_mels, 4))
        from qasr_torch.features.frontend import featurize_waveform

        batch[0, :feats_len] = featurize_waveform(wavs[1], tr.fcfg, device="cpu")
        leaked = tr.model(batch)
    assert (leaked[0, :n] - alone[0, :n]).abs().max() > 1e-3


def test_supported_refuses_past_its_bound():
    bf16, f32 = torch.bfloat16, torch.float32
    # the cooperative grid (2H/4 blocks, one an SM) bounds it: 132 SMs on an
    # H100 SXM, the default
    assert qlstm_scan.supported(256, bf16) and qlstm_scan.supported(256, f32)
    assert not qlstm_scan.supported(272, bf16) and not qlstm_scan.supported(272, f32)
    # a card with fewer SMs (an H100 PCIe has 114) refuses a smaller grid
    assert qlstm_scan.supported(224, bf16, sms=114)
    assert not qlstm_scan.supported(240, bf16, sms=114)
    assert not qlstm_scan.supported(256, f32, sms=114)
    # off the card the bound is the H100 SXM's
    assert qlstm_scan.device_sms("cpu") == qlstm_scan.H100_SMS == 132
    # the mma k-step, the dtypes
    for hid in (8, 24, 0):
        assert not qlstm_scan.supported(hid, bf16)
    assert qlstm_scan.supported(16, bf16)
    assert not qlstm_scan.supported(128, torch.float16)
    # the launcher refuses before it touches a device
    xz = torch.zeros((2, 2, 1, 16 * 272), dtype=bf16)
    with pytest.raises(ValueError, match="does not support hidden=272"):
        qlstm_scan.qlstm_scan_cuda(xz, torch.zeros((2, 8, 272, 4 * 272), dtype=bf16))
    with pytest.raises(ValueError, match="both directions"):
        qlstm_scan.qlstm_scan_cuda(xz[:, :1, :, : 16 * 16], torch.zeros((1, 8, 16, 64), dtype=bf16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        qlstm_scan.qlstm_scan_cuda(xz[..., : 16 * 16], torch.zeros((2, 8, 16, 64), dtype=bf16))


def test_qlstm_routing(monkeypatch):
    m = get_config("librispeech_qlstm").model
    assert qlstm_routing(m, "cuda") == ("auto", "pallas8")
    assert qlstm_routing(m, torch.device("cuda", 0)) == ("auto", "pallas8")
    assert qlstm_routing(m, "cpu") == ("auto", "fast8")
    # the bound is the given card's: 114 SMs cannot hold H=256's 128 blocks
    with monkeypatch.context() as mp:
        mp.setattr(qlstm_scan, "device_sms", lambda device: 114)
        assert qlstm_routing(m, "cuda") == ("auto", "fast8")
    f32 = get_config("librispeech_qlstm").override(**{"model.compute_dtype": "float32"}).model
    assert qlstm_routing(f32, "cuda") == ("auto", "pallas8")
    wide = get_config("librispeech_qlstm").override(**{"model.lstm_features": 272}).model
    assert qlstm_routing(wide, "cuda") == ("auto", "fast8")
    for variant, want in (("fast8_recurrent", ("auto", "pallas8")),
                          ("pallas8", ("pallas8", "pallas8"))):
        mv = get_config("librispeech_qlstm").override(**{"model.op_variant": variant}).model
        assert qlstm_routing(mv, "cuda") == want
    # the block recurrence, and the unidirectional layer (never kernel D):
    # tests/test_torch_qlstm_arms.py holds the whole table
    for over, want in (({"model.op_variant": "block"}, ("block", "block")),
                       ({"model.op_variant": "fast8"}, ("fast8", "block")),
                       ({"model.bidirectional": False}, ("auto", "fast8"))):
        assert qlstm_routing(get_config("librispeech_qlstm").override(**over).model,
                             "cuda") == want
    with pytest.raises(ValueError, match="not valid for arch='qlstm'"):
        qlstm_routing(get_config("librispeech_qlstm").override(
            **{"model.op_variant": "fast10"}).model, "cuda")
    # qlstm trains, with the serving routing: off the card, the fast8 loop
    trained = build_model(CFG, device="cpu", train=True)
    assert trained.training and trained.recurrent == "fast8"
    assert trained.qbilstm_0.input_proj == "auto"


def test_input_projection_arms_agree():
    """``auto`` takes kernel B below ``BLOCK_ROWS`` rows and the block
    product from it; both compute the same quaternion product."""
    assert input_proj_fn("auto", BLOCK_ROWS - 1) is qdense_pallas8
    assert input_proj_fn("auto", BLOCK_ROWS) is not qdense_pallas8
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((37, 4 * 24)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((4, 24, 40)) * 0.2).astype(np.float32))
    block = input_proj_fn("block", 37)(x, w)
    rank8 = input_proj_fn("fast8", 37)(x, w)
    torch.testing.assert_close(rank8, block, rtol=1e-5, atol=1e-5)
