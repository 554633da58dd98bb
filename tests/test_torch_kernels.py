"""qasr_torch's two kernel modules against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version; that is
what is held here against the JAX XLA paths and against the Pallas kernels
in interpret mode (as tests/test_pallas.py and tests/test_qconv_chain.py run
them). The CUDA kernels themselves are checked against the plain versions by
tests/test_torch_cuda.py, which skips without a card, and by chip_smoke.py.

Inputs are numpy-seeded, f32. Tolerance: rtol/atol 1e-4 — sums of up to
9*256 products in another order (f32 eps 1.2e-7 times sqrt(K) ~ 50, with
margin).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from qasr.ops.pallas import qconv_chain as jchain
from qasr.ops.pallas import qconv_ft as jft
from qasr.ops.pallas import qgemm8 as jgemm
from qasr.ops.qlinalg import qdense as jqdense
from qasr_torch.ops.kernels import qconv_chain, qconv_ft, qgemm8

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# kernel A: rank-8 stacked conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "c,kernel,t",
    [(8, (3, 3), 16), (16, (3, 3), 13), (8, (3, 5), 11), (16, (5, 3), 7)],
)
def test_qconv_plain_matches_stacked_xla(c, kernel, t):
    """Plain version vs qconv_fast8_stacked: narrow widths, non-square
    kernels (orientation: kh over T, kw over F) and ragged T."""
    rng = np.random.default_rng(c + t)
    x = _rand(rng, 2, 4, 5, t, c)
    w = _rand(rng, 4, *kernel, c, 2 * c, scale=0.2)
    want = np.asarray(jft.qconv_fast8_stacked(jnp.asarray(x), jnp.asarray(w)))
    got = qconv_ft.qconv_ft8(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_qconv_plain_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    x = _rand(rng, 1, 4, 5, 32, 128, scale=0.5)
    w = _rand(rng, 4, 3, 3, 128, 128, scale=0.05)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jft.qconv2d_ft8_stacked(jnp.asarray(x), jnp.asarray(w)))
    got = qconv_ft.qconv_ft8(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("t", [32, 40])  # tile-exact and masked tail on the TPU
def test_chain_layer_matches_pallas_chain(t):
    """bias + qconv8(prelu_prev(x)) against qconv_chain.chain_layer with
    chain_entry/chain_exit, prologue on, in interpret mode."""
    rng = np.random.default_rng(t)
    c = 128
    x = _rand(rng, 1, 4, 5, t, c, scale=0.5)
    w = _rand(rng, 4, 3, 3, c, c, scale=0.05)
    bias = _rand(rng, 4 * c, scale=0.1)
    alpha = np.abs(_rand(rng, 4 * c, scale=0.25))
    with pltpu.force_tpu_interpret_mode():
        xp = jchain.chain_entry(jnp.asarray(x), 3)
        z = jchain.chain_layer(
            xp, jnp.asarray(w), jnp.asarray(bias), jnp.asarray(alpha), t_valid=t
        )
        want = np.asarray(jchain.chain_exit(z, 5, t, 3))
    got = qconv_chain.chain_layer(_t(x), _t(w), _t(bias), _t(alpha)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    plain = qconv_chain.chain_layer(_t(x), _t(w), _t(bias), _t(alpha), plain=True).numpy()
    np.testing.assert_array_equal(plain, got)


def test_chain_layer_without_prologue_is_conv_plus_bias():
    rng = np.random.default_rng(9)
    x = _rand(rng, 2, 4, 3, 9, 8)
    w = _rand(rng, 4, 3, 3, 8, 8, scale=0.2)
    bias = _rand(rng, 32)
    want = np.asarray(jft.qconv_fast8_stacked(jnp.asarray(x), jnp.asarray(w)))
    want = want + bias.reshape(4, 1, 1, 8)
    got = qconv_chain.chain_layer(_t(x), _t(w), _t(bias), None).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_layout_converters_match_reference():
    x = _rand(np.random.default_rng(3), 2, 5, 6, 12)
    want = np.asarray(jft.pack_to_stacked(jnp.asarray(x)))
    st = qconv_ft.pack_to_stacked(_t(x))
    np.testing.assert_array_equal(st.numpy(), want)
    np.testing.assert_array_equal(qconv_ft.stacked_to_pack(st).numpy(), x)


def test_scheme_tables_match_reference():
    for name in ("SCHEME8", "SCHEME10"):
        got, want = getattr(qconv_ft, name), getattr(jft, name)
        assert got.fwd_in == want.fwd_in and got.fwd_out == want.fwd_out
        np.testing.assert_array_equal(got.u, want.u)
        np.testing.assert_array_equal(got.v_mat, want.v_mat)
        np.testing.assert_array_equal(got.o_mat, want.o_mat)


def test_supported_gate():
    ok = qconv_ft.supported
    assert ok(256, 256, (3, 3))
    assert ok(8, 16, (3, 5))
    assert not ok(12, 16, (3, 3))               # not a multiple of 8
    assert not ok(16, 16, (2, 3))               # even kernel
    assert not ok(16, 16, (3, 3), "VALID")
    assert not ok(16, 16, (3, 3), strides=(2, 1))
    assert ok(16, 16, (5, 5)) and ok(16, 16, (1, 5))
    for kernel in ((7, 7), (3, 7), (7, 3)):
        assert not ok(16, 16, kernel)           # past the 5x5 shared-memory bound


# ---------------------------------------------------------------------------
# kernel B: rank-8 GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(12, 128, 128), (7, 256, 62)])
def test_qgemm8_plain_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(m)
    x = _rand(rng, m, 4 * k)
    w = _rand(rng, 4, k, n, scale=0.1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgemm.qdense_pallas8(jnp.asarray(x), jnp.asarray(w)))
    got = qgemm8.qdense_pallas8(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_qgemm8_plain_matches_block_dense_ragged():
    rng = np.random.default_rng(11)
    x = _rand(rng, 3, 5, 4 * 13)
    w = _rand(rng, 4, 13, 9, scale=0.3)
    want = np.asarray(jqdense(jnp.asarray(x), jnp.asarray(w)))
    got = qgemm8.qdense_pallas8(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    x4 = _t(x).reshape(15, 4, 13).transpose(0, 1)
    np.testing.assert_allclose(
        qgemm8.qgemm8_cl(x4, _t(w)).transpose(0, 1).reshape(3, 5, 36).numpy(), want, **TOL
    )


# ---------------------------------------------------------------------------
# wrappers: the plain version only for CPU tensors, no silent fallback
# ---------------------------------------------------------------------------


def test_cpu_calls_do_not_count_launches():
    rng = np.random.default_rng(0)
    a0, b0 = qconv_ft.qconv_ft8.launches, qgemm8.qgemm8_cl.launches
    qconv_ft.qconv_ft8(_t(_rand(rng, 1, 4, 3, 4, 8)), _t(_rand(rng, 4, 3, 3, 8, 8)))
    qgemm8.qgemm8_cl(_t(_rand(rng, 4, 5, 8)), _t(_rand(rng, 4, 8, 8)))
    assert (qconv_ft.qconv_ft8.launches, qgemm8.qgemm8_cl.launches) == (a0, b0)
    if not torch.cuda.is_available():
        assert (a0, b0) == (0, 0)


def test_kernel_entries_refuse_cpu_tensors():
    """Asking for a kernel without a CUDA tensor raises; nothing falls back
    to the plain version."""
    a0, b0 = qconv_ft.qconv_ft8.launches, qgemm8.qgemm8_cl.launches
    x = torch.zeros(1, 4, 3, 8, 8)
    wc = torch.zeros(8, 3, 3, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        qconv_ft.qconv_ft8_cuda(x, wc)
    with pytest.raises(ValueError, match="CUDA"):
        qgemm8.qgemm8_cuda(torch.zeros(4, 5, 8), torch.zeros(8, 8, 8))
    with pytest.raises(TypeError):
        qconv_ft.qconv_ft8_cuda(x.half(), wc.half())
    with pytest.raises(ValueError, match="does not support"):
        qconv_ft.qconv_ft8_cuda(torch.zeros(1, 4, 3, 8, 12), torch.zeros(8, 3, 3, 12, 8))
    assert (qconv_ft.qconv_ft8.launches, qgemm8.qgemm8_cl.launches) == (a0, b0)
