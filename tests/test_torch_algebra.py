"""qasr_torch quaternion algebra against the JAX reference (qasr.ops).

Inputs are numpy-seeded and fed to both packages in f32. Tolerances: table
copies are exact; the ops are f32 sums of a few hundred terms taken in a
different order, held to rtol/atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.ops import qlinalg as jq
from qasr.ops import quaternion as jquat
from qasr_torch.ops import qlinalg as tq
from qasr_torch.ops import quaternion as tquat

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize(
    "name",
    ["HAMILTON_COMP", "HAMILTON_SIGN", "HAMILTON_E", "X_COMBO", "W_COMBO",
     "OUT_COMBO", "U8", "V8", "O8"],
)
def test_tables_equal_reference(name):
    got, want = getattr(tquat, name), getattr(jquat, name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(4, 5, 7), (4, 3, 3, 2, 6), (4, 3, 5, 1, 8)])
@pytest.mark.parametrize("conjugate", [False, True])
def test_hamilton_expand(shape, conjugate):
    w = _rand(np.random.default_rng(0), *shape)
    want = np.asarray(jquat.hamilton_expand(jnp.asarray(w), conjugate=conjugate))
    got = tquat.hamilton_expand(torch.from_numpy(w), conjugate=conjugate).numpy()
    np.testing.assert_array_equal(got, want)


def test_hamilton_product():
    rng = np.random.default_rng(1)
    a, b = _rand(rng, 3, 8), _rand(rng, 3, 8)
    want = np.asarray(jquat.hamilton_product(jnp.asarray(a), jnp.asarray(b)))
    got = tquat.hamilton_product(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("lead", [(6,), (2, 5)])
def test_qdense_and_fast8(lead):
    rng = np.random.default_rng(2)
    x = _rand(rng, *lead, 4 * 12)
    w = _rand(rng, 4, 12, 7, scale=0.3)
    want = np.asarray(jq.qdense(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(tq.qdense(torch.from_numpy(x), torch.from_numpy(w)).numpy(), want, **TOL)
    np.testing.assert_allclose(
        tq.qdense_fast8(torch.from_numpy(x), torch.from_numpy(w)).numpy(), want, **TOL
    )
    want8 = np.asarray(jq.qdense_fast8(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(
        tq.qdense_fast8(torch.from_numpy(x), torch.from_numpy(w)).numpy(), want8, **TOL
    )


@pytest.mark.parametrize("kernel", [(3, 3), (3, 5), (5, 3)])
@pytest.mark.parametrize("cin", [1, 3])
def test_qconv_2d(kernel, cin):
    """Packed [B, T, F, 4C] with w [4, kh (T), kw (F), Cin, Cout]: the
    non-square kernels pin the orientation."""
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 9, 7, 4 * cin)
    w = _rand(rng, 4, *kernel, cin, 5, scale=0.3)
    want = np.asarray(jq.qconv(jnp.asarray(x), jnp.asarray(w)))
    got = tq.qconv(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_qconv_1d_and_valid():
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 11, 4 * 2)
    w = _rand(rng, 4, 3, 2, 3, scale=0.3)
    for padding in ("SAME", "VALID"):
        want = np.asarray(jq.qconv(jnp.asarray(x), jnp.asarray(w), padding=padding))
        got = tq.qconv(torch.from_numpy(x), torch.from_numpy(w), padding=padding).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_combine_weights_is_u8_einsum():
    w = _rand(np.random.default_rng(5), 4, 3, 3, 2, 4)
    want = np.einsum("a...,pa->p...", w.astype(np.float64), jquat.U8)
    got = tquat.combine_weights(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
