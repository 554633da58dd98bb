"""The rank-8 quaternion GEMM keeps its products in f32 until the fold, as the
JAX package's ``preferred_element_type=f32`` dots do: kernel B's plain
version (``qgemm8_cl_plain``), its dW (``qgemm8_dw``, both branches at
``K*N >= 2**20``) and ``qdense_fast8``, on bf16 inputs.

Standard: the outputs that differ from the JAX package's bf16 outputs are
those that the f32 summation order explains. Each differs by at most one bf16
ulp of its value, or, for a value near zero, by at most the f32 sum's own
error (1e-6 of the largest output: an M-long f32 sum errs by ~sqrt(M) 2^-24
of its terms' scale). At most 0.1% of the outputs differ (measured: 0.006% to
0.024%). The form these replaced, each product rounded to bf16 before the
f32 fold, makes 40-51% of the outputs differ: each test holds that form
against the same reference as its control.

The JAX references: ``qasr.ops.qlinalg.qdense_fast8`` (XLA) and
``qasr.ops.pallas.qgemm8`` (the Pallas kernel, and the VJP of ``qgemm8_cl``)
through ``tests/pallas_interpret.py``, each one ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.ops import qlinalg as jlinalg
from qasr.ops.pallas import qgemm8 as jgemm
from qasr_torch.ops import qlinalg
from qasr_torch.ops.kernels import qgemm8
from qasr_torch.ops.quaternion import HAMILTON_E, O8, O8_T, U8, V8, combine_weights, device_table
from tests.pallas_interpret import hlo_interpret

torch.set_num_threads(1)
bf16 = torch.bfloat16
MAX_SHARE = 1e-3  # of the outputs that may differ
OLD_SHARE = 0.3   # the bf16-product form differs in more than this


def _explained(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Where ``got`` differs from ``want`` by more than one bf16 ulp of
    ``want`` and by more than the f32 sum's error (1e-6 of the scale)."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-38))) - 7)
    return np.abs(got - want) <= np.maximum(ulp, 1e-6 * np.abs(want).max())


def _hold(got: np.ndarray, want: np.ndarray, old: np.ndarray) -> float:
    differ = (got != want).mean()
    assert _explained(got, want).all()
    assert differ <= MAX_SHARE, differ
    assert (old != want).mean() > OLD_SHARE  # the control: bf16 products
    return differ


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(bf16)


def _np(t) -> np.ndarray:
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jax.Array) else t.float().numpy()


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, 4 * k)).astype(np.float32)
    return x, (rng.standard_normal((4, k, n)) / np.sqrt(k)).astype(np.float32)


def _old_fast8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``qdense_fast8`` as it was: the products rounded to x's dtype."""
    k = w.shape[1]
    xc = torch.einsum("...ak,pa->...pk", x.reshape(*x.shape[:-1], 4, k),
                      device_table(V8, x.dtype, x.device))
    prods = torch.einsum("...pk,pkn->...pn", xc, combine_weights(w, x.dtype)).float()
    ys = torch.einsum("...pn,bp->...bn", prods, device_table(O8, torch.float32, x.device))
    return ys.reshape(*x.shape[:-1], -1).to(x.dtype)


def _old_plain(x4: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``qgemm8_cl_plain`` as it was."""
    prods = torch.bmm(qgemm8.combos8(x4), combine_weights(w, x4.dtype)).float()
    return torch.einsum("pmn,bp->bmn", prods, device_table(O8, torch.float32, x4.device)).to(
        x4.dtype)


def _old_dw(x4: torch.Tensor, dy4: torch.Tensor) -> torch.Tensor:
    """``qgemm8_dw`` as it was, both branches."""
    k, n = x4.shape[2], dy4.shape[2]
    if k * n >= 1 << 20:
        xc = torch.einsum("amk,pa->pmk", x4, device_table(V8, x4.dtype, x4.device))
        dyc = torch.einsum("bmn,pb->pmn", dy4, device_table(O8_T, dy4.dtype, dy4.device))
        dwc8 = torch.bmm(xc.transpose(1, 2), dyc).float()
        return torch.einsum("pkn,pa->akn", dwc8, device_table(U8, torch.float32, x4.device))
    dw_big = torch.einsum("amk,bmn->akbn", x4, dy4).float()
    return torch.einsum("akbn,cab->ckn", dw_big, device_table(HAMILTON_E, torch.float32, "cpu"))


@pytest.mark.parametrize("m,k,n", [(64, 256, 64), (37, 96, 40)])
def test_qdense_fast8_sums_products_in_f32(m, k, n):
    """``qdense_fast8`` in bf16 against ``qasr.ops.qlinalg.qdense_fast8``."""
    x, w = _inputs(m, k, n, seed=m + k)
    want = _np(jax.jit(jlinalg.qdense_fast8)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w)))
    got = qlinalg.qdense_fast8(_bf16(x), torch.from_numpy(w))
    assert got.dtype == bf16
    _hold(_np(got), want, _np(_old_fast8(_bf16(x), torch.from_numpy(w))))


@pytest.mark.parametrize("m,k,n", [(64, 256, 64), (37, 96, 40)])
def test_plain_qgemm8_sums_products_in_f32(m, k, n):
    """Kernel B's plain version in bf16 against the interpreted Pallas
    kernel (``qdense_pallas8``), whose input combos it forms term by
    term."""
    x, w = _inputs(m, k, n, seed=m * k)
    with hlo_interpret():
        want = _np(jax.jit(jgemm.qdense_pallas8)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w)))
    got = qgemm8.qdense_pallas8(_bf16(x), torch.from_numpy(w))
    x4 = _bf16(x).reshape(m, 4, k).transpose(0, 1)
    old = _old_plain(x4, torch.from_numpy(w)).transpose(0, 1).reshape(m, 4 * n)
    _hold(_np(got), want, _np(old))


# (128, 256, 256): K*N < 2**20, the block product folded with the Hamilton
# table; (64, 1024, 1024): the rank-8 form folded with U8
@pytest.mark.parametrize("m,k,n", [(128, 256, 256), (64, 1024, 1024)])
def test_qgemm8_dw_sums_products_in_f32(m, k, n):
    """dW of the rank-8 GEMM against the VJP of ``qgemm8_cl`` (the Pallas
    kernel interpreted, its dW in XLA): with bf16 weights the bf16 dW, with
    f32 weights the f32 dW (summation order only: 1e-6 of the largest)."""
    rng = np.random.default_rng(k + n)
    x4 = rng.standard_normal((4, m, k)).astype(np.float32)
    w = (rng.standard_normal((4, k, n)) / np.sqrt(k)).astype(np.float32)
    dy4 = rng.standard_normal((4, m, n)).astype(np.float32)
    vjp = jax.jit(lambda xx, ww, dd: jax.vjp(jgemm.qgemm8_cl, xx, ww)[1](dd))
    jx, jdy = jnp.asarray(x4, jnp.bfloat16), jnp.asarray(dy4, jnp.bfloat16)
    with hlo_interpret():
        _, want = vjp(jx, jnp.asarray(w, jnp.bfloat16), jdy)
        _, want32 = vjp(jx, jnp.asarray(w), jdy)
    got = qgemm8.qgemm8_dw(_bf16(x4), _bf16(dy4))
    assert got.dtype == torch.float32 and got.shape == (4, k, n)
    _hold(_np(got.to(bf16)), _np(want), _np(_old_dw(_bf16(x4), _bf16(dy4)).to(bf16)))
    want32 = np.asarray(want32)
    assert np.abs(got.numpy() - want32).max() <= 1e-6 * np.abs(want32).max()
    # the train step's route: QGemm8Fn's backward hands back w's dtype
    tx = _bf16(x4).requires_grad_()
    tw = _bf16(w).requires_grad_()
    qgemm8.QGemm8Fn.apply(tx, tw).backward(_bf16(dy4))
    np.testing.assert_array_equal(_np(tw.grad), _np(got.to(bf16)))


def test_f32_bmm_upcasts_off_the_card():
    """On the CPU a bf16 pair is upcast: the products and their sum are the
    f32 ones, and the result is f32."""
    rng = np.random.default_rng(3)
    a, b = _bf16(rng.standard_normal((2, 5, 300))), _bf16(rng.standard_normal((2, 300, 7)))
    got = qgemm8.f32_bmm(a, b)
    assert got.dtype == torch.float32
    want = np.einsum("bik,bkj->bij", _np(a).astype(np.float64), _np(b).astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got, torch.bmm(a.float(), b.float()), rtol=0, atol=0)
