"""Gradients of the port's kernel modules against the JAX package's VJPs.

On the CPU, :class:`ChainLayerFn` and :class:`QGemm8Fn` run their kernels'
plain versions (kernel A forward; kernel C for dx and dalpha; kernel B on
the conj-transposed weights for the GEMM's dx) with their own dW and db.
They are called directly here, so their backward passes are what is held:
against ``jax.vjp`` of the Pallas kernels in interpret mode (as
tests/test_qconv_chain.py and tests/test_pallas.py run them), and against
the XLA custom VJP of ``qconv_fast8_stacked``. The kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Inputs and cotangents are numpy-seeded, f32. Tolerance: 1e-4 relative to
each gradient's largest magnitude; the sums run over at most a few thousand
products in another order (f32 eps 1.2e-7 times sqrt(n) ~ 1e-5, with
margin).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from qasr.ops.pallas import qconv_chain as jchain
from qasr.ops.pallas import qconv_ft as jft
from qasr.ops.pallas import qgemm8 as jgemm
from qasr_torch.ops.kernels import qconv_dx8, qgemm8
from qasr_torch.ops.kernels.qconv_chain import ChainLayerFn, chain_layer

# the package exports a function of the module's name
jqgemm = importlib.import_module("qasr.ops.pallas.qgemm")

torch.set_num_threads(1)
REL = 1e-4


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, name):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * scale, err_msg=name)


def _jprelu(x, alpha):
    return jnp.where(x >= 0, x, alpha.reshape(4, 1, 1, -1) * x)


def _layer_inputs(seed, c_in, c_out, kernel, t, *, f=4, negative_alpha=False):
    rng = np.random.default_rng(seed)
    x = _rand(rng, 2, 4, f, t, c_in, scale=0.5)
    w = _rand(rng, 4, *kernel, c_in, c_out, scale=0.2)
    bias = _rand(rng, 4 * c_out, scale=0.1)
    alpha = _rand(rng, 4 * c_in, scale=0.25)
    if not negative_alpha:
        alpha = np.abs(alpha)
    dz = _rand(rng, 2, 4, f, t, c_out)
    return x, w, bias, alpha, dz


def _port_layer_grads(x, w, bias, alpha, dz, prologue, fn=ChainLayerFn.apply):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, bias, alpha)]
    z = fn(ts[0], ts[1], ts[2], ts[3] if prologue else None)
    z.backward(torch.from_numpy(dz))
    return z, [t.grad for t in ts]


# ---------------------------------------------------------------------------
# kernel C's plain version and ChainLayerFn, against the XLA custom VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kernel,t,negative_alpha",
    [((3, 5), 11, False), ((5, 3), 7, True)],
)
def test_qconv_dx8_plain_matches_xla_vjp(kernel, t, negative_alpha):
    """dx of the transposed conv alone (the first stacked layer: no
    epilogue) and with the PReLU backward (dx, dalpha), against
    ``jax.vjp`` of ``qconv_fast8_stacked(prelu(z), w)``."""
    z, w, _, alpha, dz = _layer_inputs(1, 8, 16, kernel, t, negative_alpha=negative_alpha)
    jw = jnp.asarray(w)
    _, vjp = jax.vjp(lambda x: jft.qconv_fast8_stacked(x, jw), jnp.asarray(z))
    (want_dx,) = vjp(jnp.asarray(dz))
    dx, dalpha = qconv_dx8.qconv_dx8(torch.from_numpy(dz), torch.from_numpy(w))
    assert dalpha is None
    _close(dx, want_dx, "dx without epilogue")

    _, vjp = jax.vjp(
        lambda zz, a: jft.qconv_fast8_stacked(_jprelu(zz, a), jw), jnp.asarray(z), jnp.asarray(alpha)
    )
    want_dx, want_da = vjp(jnp.asarray(dz))
    dx, dalpha = qconv_dx8.qconv_dx8(
        torch.from_numpy(dz), torch.from_numpy(w), torch.from_numpy(z), torch.from_numpy(alpha)
    )
    _close(dx, want_dx, "dx with epilogue")
    _close(dalpha, want_da, "dalpha")


@pytest.mark.parametrize(
    "kernel,t,negative_alpha,prologue",
    [((3, 5), 12, True, True), ((5, 3), 7, False, True), ((3, 3), 9, False, False)],
)
def test_chain_layer_fn_grads_match_xla_vjp(kernel, t, negative_alpha, prologue):
    """d/d{x, w, bias, alpha_prev} of ``bias + qconv8(prelu(x))``: the
    autograd function against the XLA custom VJP, and the plain path's
    autograd (what ``chain_layer`` runs on the CPU) against both."""
    x, w, bias, alpha, dz = _layer_inputs(
        2, 16, 8, kernel, t, negative_alpha=negative_alpha
    )

    def ref(xx, ww, bb, aa):
        xin = _jprelu(xx, aa) if prologue else xx
        return jft.qconv_fast8_stacked(xin, ww) + bb.reshape(4, 1, 1, -1)

    want_z, vjp = jax.vjp(ref, *map(jnp.asarray, (x, w, bias, alpha)))
    want = vjp(jnp.asarray(dz))
    z, got = _port_layer_grads(x, w, bias, alpha, dz, prologue)
    _close(z, want_z, "z")
    _, plain = _port_layer_grads(x, w, bias, alpha, dz, prologue, fn=chain_layer)
    for name, g, p, wg in zip(("x", "w", "bias", "alpha"), got, plain, want):
        if name == "alpha" and not prologue:
            assert g is None and p is None
            continue
        _close(g, wg, f"d{name}")
        _close(p, wg, f"d{name} (plain autograd)")


@pytest.mark.parametrize(
    "kernel,negative_alpha,prologue",
    [((3, 5), True, True), ((5, 3), False, False)],
)
def test_chain_layer_fn_grads_match_pallas_chain(kernel, negative_alpha, prologue):
    """Against ``jax.vjp`` of the Pallas chain layer (``_fwd_kernel`` and
    ``_dx_kernel``) with chain_entry/chain_exit, in interpret mode, at its
    128-channel tile; T=20 leaves a ragged tail in its 32-row time tile."""
    t, f, c = 20, 3, 128
    rng = np.random.default_rng(3)
    x = _rand(rng, 1, 4, f, t, c, scale=0.5)
    w = _rand(rng, 4, *kernel, c, c, scale=0.05)
    bias = _rand(rng, 4 * c, scale=0.1)
    alpha = _rand(rng, 4 * c, scale=0.25)
    if not negative_alpha:
        alpha = np.abs(alpha)
    dz = _rand(rng, 1, 4, f, t, c)
    kw = kernel[1]

    def ref(xx, ww, bb, aa):
        xp = jchain.chain_entry(xx, kw)
        zp = jchain.chain_layer(xp, ww, bb, aa if prologue else None, t_valid=t)
        return jchain.chain_exit(zp, f, t, kw)

    with pltpu.force_tpu_interpret_mode():
        want_z, vjp = jax.vjp(ref, *map(jnp.asarray, (x, w, bias, alpha)))
        want = vjp(jnp.asarray(dz))
    z, got = _port_layer_grads(x, w, bias, alpha, dz, prologue)
    _close(z, want_z, "z")
    for name, g, wg in zip(("x", "w", "bias", "alpha"), got, want):
        if name == "alpha" and not prologue:
            assert g is None
            continue
        _close(g, wg, f"d{name}")


def test_conj_transpose_matches_reference():
    rng = np.random.default_rng(4)
    w = _rand(rng, 4, 3, 5, 8, 16)
    np.testing.assert_array_equal(
        qconv_dx8.conj_transpose_w(torch.from_numpy(w)).numpy(),
        np.asarray(jft._conj_transpose_w(jnp.asarray(w))),
    )
    wd = _rand(rng, 4, 12, 20)
    np.testing.assert_array_equal(
        qgemm8.conj_transpose_dense(torch.from_numpy(wd)).numpy(),
        np.asarray(jqgemm._conj_transpose_w(jnp.asarray(wd))),
    )


# ---------------------------------------------------------------------------
# QGemm8Fn: dx (kernel B on the adjoint combos) and both dW branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "m,k,n",
    [
        (12, 128, 128),   # k*n < 2**20: the block [4,K,4,N] dot folded by HAMILTON_E
        (8, 1024, 1024),  # k*n >= 2**20: the rank-8 dot on the combos
    ],
)
def test_qgemm8_fn_grads_match_pallas(m, k, n):
    rng = np.random.default_rng(m + k)
    x4 = _rand(rng, 4, m, k, scale=0.5)
    w = _rand(rng, 4, k, n, scale=0.05)
    dy4 = _rand(rng, 4, m, n)
    with pltpu.force_tpu_interpret_mode():
        want_y, vjp = jax.vjp(jgemm.qgemm8_cl, jnp.asarray(x4), jnp.asarray(w))
        want_dx, want_dw = vjp(jnp.asarray(dy4))
    tx, tw = torch.from_numpy(x4).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = qgemm8.QGemm8Fn.apply(tx, tw)
    y.backward(torch.from_numpy(dy4))
    _close(y, want_y, "y")
    _close(tx.grad, want_dx, "dx")
    _close(tw.grad, want_dw, "dw")
    _close(qgemm8.qgemm8_dx(torch.from_numpy(dy4), torch.from_numpy(w)), want_dx, "qgemm8_dx")


def test_qgemm8_dense_grads_ragged_match_block_dense():
    """Through the packed wrapper with ragged K and N, against autodiff of
    the reference's block dense (``qasr.ops.qlinalg.qdense``)."""
    from qasr.ops.qlinalg import qdense as jqdense

    rng = np.random.default_rng(5)
    x = _rand(rng, 3, 5, 4 * 13)
    w = _rand(rng, 4, 13, 9, scale=0.3)
    dy = _rand(rng, 3, 5, 36)
    _, vjp = jax.vjp(jqdense, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    x4 = tx.reshape(15, 4, 13).transpose(0, 1)
    y4 = qgemm8.QGemm8Fn.apply(x4, tw)
    y4.transpose(0, 1).reshape(3, 5, 36).backward(torch.from_numpy(dy))
    _close(tx.grad, want_dx, "dx")
    _close(tw.grad, want_dw, "dw")


# ---------------------------------------------------------------------------
# the wrappers: plain version only for CPU tensors, no silent fallback
# ---------------------------------------------------------------------------


def test_backward_kernel_entries_refuse_cpu_tensors():
    c0, d0 = qconv_dx8.qconv_dx8.launches, qgemm8.qgemm8_dx.launches
    dz = torch.zeros(1, 4, 3, 8, 8)
    wc = torch.zeros(8, 3, 3, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        qconv_dx8.qconv_dx8_cuda(dz, wc)
    with pytest.raises(ValueError, match="together"):
        qconv_dx8.qconv_dx8_cuda(dz, wc, torch.zeros(1, 4, 3, 8, 8), None)
    with pytest.raises(ValueError, match="does not support"):
        qconv_dx8.qconv_dx8_cuda(torch.zeros(1, 4, 3, 8, 12), torch.zeros(8, 3, 3, 12, 8))
    with pytest.raises(ValueError, match="CUDA"):
        qgemm8.qgemm8_cuda(torch.zeros(4, 5, 8), torch.zeros(8, 8, 8), role="dx")
    # CPU tensors take the plain versions and count no launch
    qconv_dx8.qconv_dx8(dz, torch.zeros(4, 3, 3, 8, 8))
    qgemm8.qgemm8_dx(torch.zeros(4, 5, 8), torch.zeros(4, 8, 8))
    assert (qconv_dx8.qconv_dx8.launches, qgemm8.qgemm8_dx.launches) == (c0, d0)
    if not torch.cuda.is_available():
        assert (c0, d0) == (0, 0)
