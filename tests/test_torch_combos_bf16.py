"""The weight combos of the rank-8 and 10-product schemes in bf16, bit for bit
against the JAX package's einsums.

The reference casts each quaternion layer's kernel to the compute dtype
(``qasr/models/layers.py``) and forms a combo as ``einsum(w, asarray(table,
w.dtype))``: in bf16 the table's coefficients are rounded to bf16 first, the
products summed and the sum rounded once to bf16 (``qasr/ops/qlinalg.py``,
``qasr/ops/pallas/qgemm8.py``, ``qconv_ft.py``, ``qconv_chain.py``).
``qasr_torch.ops.quaternion.combine_weights`` does the same, and every layer
hands it the kernel in the compute dtype. Each test records the combos that
a port layer (or a kernel's plain version) actually forms, on the CPU, and
holds them against the jitted JAX einsum on the same bf16 kernel. The
recurrent weights are combined from f32 in both packages, and stay so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.ops.quaternion import U8 as JU8, W_COMBO as JW_COMBO, X_COMBO as JX_COMBO
from qasr_torch.models import layers, qlstm
from qasr_torch.ops import qlinalg, quaternion
from qasr_torch.ops.kernels import qconv_dx, qconv_ft, qgemm8
from qasr_torch.ops.kernels.qconv_dx import conj_transpose_w
from qasr_torch.ops.kernels.qgemm8 import conj_transpose_dense
from qasr_torch.ops.quaternion import U8, W_COMBO, X_COMBO, combine_weights, device_table

torch.set_num_threads(1)
bf16 = torch.bfloat16
CPU = torch.device("cpu")


def _jax_combos(w: np.ndarray, table: np.ndarray, w_dtype=jnp.bfloat16) -> np.ndarray:
    """The reference's rule: ``einsum(w, asarray(table, w.dtype))`` on w in
    ``w_dtype``, flattened over w's trailing dims, then cast to bf16 (the
    compute dtype), jitted; returned as f32."""

    @jax.jit
    def f(wj):
        flat = wj.reshape(4, -1)
        wc = jnp.einsum("am,pa->pm", flat, jnp.asarray(table, wj.dtype))
        return wc.astype(jnp.bfloat16).reshape(table.shape[0], *wj.shape[1:])

    return np.asarray(f(jnp.asarray(w, w_dtype)).astype(jnp.float32))


class _Spy:
    """Records ``(w, dtype, table, combos)`` of every ``combine_weights``
    call made through ``module``'s name for it."""

    def __init__(self, monkeypatch, *modules):
        self.calls = []
        for m in modules:
            monkeypatch.setattr(m, "combine_weights", self)

    def __call__(self, w, dtype=None, table=U8):
        out = combine_weights(w, dtype, table)
        self.calls.append((w.detach(), dtype, table, out.detach()))
        return out


def _spread(shape, seed: int) -> np.ndarray:
    """Values over a few binades, f32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2.0 ** rng.integers(-6, 3, shape)).astype(np.float32)


def test_tables_in_bf16_round_as_jax():
    """The port's bf16 tables equal ``jnp.asarray(table, bf16)``; the
    10-product tables' unit coefficients are exact in bf16, so rounding them
    changes nothing, where U8's move."""
    for port, ref in ((U8, JU8), (W_COMBO, JW_COMBO), (X_COMBO, JX_COMBO)):
        np.testing.assert_array_equal(port, ref)
        got = device_table(port, bf16, CPU).float().numpy()
        want = np.asarray(jnp.asarray(ref, jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
    for unit in (W_COMBO, X_COMBO):
        np.testing.assert_array_equal(device_table(unit, bf16, CPU).float().numpy(), unit)
    assert (device_table(U8, bf16, CPU).double().numpy() != U8).all()


@pytest.mark.parametrize("table", ["U8", "W_COMBO", "X_COMBO"])
def test_combine_weights_matches_jax_einsum(table):
    """``combine_weights`` on a bf16 kernel against the reference's einsum,
    bit for bit; for the unit tables also against an f32 table (the same
    bits: rounding them changes nothing), for U8 not (the repaired fault)."""
    t = {"U8": U8, "W_COMBO": W_COMBO, "X_COMBO": X_COMBO}[table]
    w = _spread((4, 3, 3, 24, 40), 1)
    wt = torch.from_numpy(w).to(bf16)
    got = combine_weights(wt, bf16, t).float().numpy()
    np.testing.assert_array_equal(got, _jax_combos(w, t))
    f32_table = torch.tensordot(
        torch.as_tensor(t, dtype=torch.float32), wt.float(), dims=([1], [0])
    ).to(bf16).float().numpy()
    if table == "U8":
        assert (f32_table != got).mean() > 0.05
    else:
        np.testing.assert_array_equal(f32_table, got)


def test_recurrent_combos_stay_f32():
    """f32 weights (the recurrent ones): the sum in f32 rounded once to bf16,
    as the reference's ``einsum(wh, asarray(U8, wh.dtype)).astype(dtype)``."""
    w = _spread((4, 16, 64), 2)
    got = combine_weights(torch.from_numpy(w), bf16).float().numpy()
    np.testing.assert_array_equal(got, _jax_combos(w, U8, jnp.float32))


def test_dense_layer_combos(monkeypatch):
    """A bf16 ``QDense`` (kernel B's plain version, forward) and kernel B's
    dx role: the combos of the bf16 kernel (dx: of its conjugate transpose)
    as the reference forms them."""
    spy = _Spy(monkeypatch, qgemm8)
    layer = layers.QDense(24, 16, dtype=bf16, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    with torch.no_grad():
        layer.kernel.copy_(torch.from_numpy(_spread((4, 24, 16), 3)))
        layer(torch.randn(5, 96))
    (w, dtype, table, wc), = spy.calls
    assert w.dtype == bf16 and dtype == bf16 and table is U8
    kernel = layer.kernel.detach().numpy()
    np.testing.assert_array_equal(wc.float().numpy(), _jax_combos(kernel, U8))
    spy.calls.clear()
    qgemm8.qgemm8_dx(torch.randn(4, 5, 16).to(bf16), layer.kernel.detach().to(bf16))
    (w, dtype, _, wc), = spy.calls
    want = _jax_combos(conj_transpose_dense(torch.from_numpy(kernel)).numpy(), U8)
    np.testing.assert_array_equal(wc.float().numpy(), want)


def test_conv_layer_combos(monkeypatch):
    """A bf16 stacked ``QConv`` (kernel A's plain version through the chain
    layer) hands its combos the bf16 kernel, as the reference's chain layer
    casts it (``qasr/models/layers.py:251``); kernel C's plain version forms
    the bf16 combos of the conjugate-transposed kernel. Failed before the
    repair: the chain layer took the f32 master kernel and U8 in f32."""
    spy = _Spy(monkeypatch, qconv_ft, qconv_dx)
    layer = layers.QConv(16, 24, layout="stacked_ft", dtype=bf16,
                         generator=torch.Generator().manual_seed(0), device=CPU)
    with torch.no_grad():
        layer.kernel.copy_(torch.from_numpy(_spread((4, 3, 3, 16, 24), 4)))
        layer(torch.randn(2, 4, 5, 8, 16))
    (w, dtype, table, wc), = spy.calls
    assert w.dtype == bf16 and table is U8
    kernel = layer.kernel.detach().numpy()
    np.testing.assert_array_equal(wc.float().numpy(), _jax_combos(kernel, U8))
    spy.calls.clear()
    dz = torch.randn(2, 4, 5, 8, 24).to(bf16)
    qconv_dx.qconv_dx_plain(dz, layer.kernel.detach().to(bf16))
    (w, _, _, wc), = spy.calls
    want = _jax_combos(conj_transpose_w(torch.from_numpy(kernel)).numpy(), U8)
    np.testing.assert_array_equal(wc.float().numpy(), want)


@pytest.mark.parametrize("input_proj", ["fast8", "pallas8"])
def test_qlstm_input_projection_combos(monkeypatch, input_proj):
    """Config 4's input projection (both directions' kernels in one bf16
    GEMM) combines the bf16 kernel; its recurrent combos stay f32's."""
    spy = _Spy(monkeypatch, qgemm8, qlinalg, qlstm)
    layer = qlstm.QBiLSTM(8, 8, dtype=bf16, input_proj=input_proj, recurrent="fast8",
                          generator=torch.Generator().manual_seed(0), device=CPU)
    with torch.no_grad():
        for cell, seed in ((layer.fwd_cell, 5), (layer.bwd_cell, 6)):
            cell.wx.copy_(torch.from_numpy(_spread(tuple(cell.wx.shape), seed)))
        layer(torch.randn(2, 6, 32), torch.tensor([6, 4]))
    proj = [c for c in spy.calls if c[0].dtype == bf16]
    rec = [c for c in spy.calls if c[0].dtype == torch.float32]
    assert len(proj) == 1 and len(rec) == 2
    wx_cat = torch.cat([layer.fwd_cell.wx, layer.bwd_cell.wx], dim=-1).detach().numpy()
    np.testing.assert_array_equal(proj[0][3].float().numpy(), _jax_combos(wx_cat, U8))
    for (w, _, _, wc), cell in zip(rec, (layer.fwd_cell, layer.bwd_cell)):
        want = _jax_combos(cell.wh.detach().numpy(), U8, jnp.float32)
        np.testing.assert_array_equal(wc.float().numpy(), want)
