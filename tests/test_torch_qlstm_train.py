"""The qasr_torch QLSTM training slice, its recurrence and one layer:
kernel E's plain version, the dW einsums, ``QLstmScanFn`` and the QBiLSTM's
parameter gradients against the JAX package (the whole encoder and the
train step: tests/test_torch_qlstm_train_model.py).

Inputs come from numpy with a seed; weights are drawn by the JAX package and
bridged into the port. On the CPU the port runs kernel E's plain version
(``qlstm_scan_bwd_plain``, the step-by-step twin of ``_bwd_xla``) under
``QLstmScanFn``, and kernel D's plain version. Where the JAX side reaches
the Pallas kernels it runs them interpreted (``FORCE_KERNEL``, as
tests/test_qlstm.py does, under ``tests/pallas_interpret.py:hlo_interpret``),
at H=128, the kernels' lane rule; each JAX reference is one ``jax.jit``
computation.

Tolerances, f32: 1e-5 against ``_bwd_xla`` and the dW einsums (sums in
another order; the measured worst is ~3e-7); 2e-4 against the interpreted
Pallas kernels, as the JAX package's own gradient test; 1e-4 for a layer's
parameter gradients (a few f32 layers deep). bf16 storage: see each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.models import qlstm as jqlstm
from qasr.ops.pallas import qlstm_scan as jscan
from qasr_torch.bridge import params_from_jax
from qasr_torch.models.qlstm import QBiLSTM
from qasr_torch.ops.kernels import qlstm_scan
from tests.pallas_interpret import hlo_interpret

torch.set_num_threads(1)
TOL_XLA = dict(rtol=1e-5, atol=1e-5)
TOL_KERNEL = dict(rtol=2e-4, atol=2e-4)
TOL_GRAD = dict(rtol=1e-4, atol=1e-4)
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

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

    def fwd_bwd(a, w, c):
        y, vjp = jax.vjp(lambda aa, ww: jscan.qlstm_scan_fast8(aa, ww, jnp.asarray(lengths)),
                         a, w)
        return (y, *vjp(c))

    with hlo_interpret():
        want, want_dxz, want_dwc8 = jax.jit(fwd_bwd)(jnp.asarray(xz), jnp.asarray(wc8),
                                                     jnp.asarray(cot))
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
    params = jax.jit(ref.init)(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(lengths))
    params = _random_biases(params["params"], seed=7)

    def jloss(p, xx):
        return jnp.sum(ref.apply({"params": p}, xx, jnp.asarray(lengths)) * cot)

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
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
