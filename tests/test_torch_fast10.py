"""The 10-product kernels' modules against the JAX package: kernel F (the
stacked conv), G (its transpose), H (the GEMM, forward and dx) and I (the
GEMM's dW).

On the CPU each wrapper runs its kernel's plain PyTorch version; that is
what is held here against the TPU kernels, interpreted as
tests/test_pallas.py and tests/test_qconv_chain.py run them (through the
HLO interpreter: ``tests/pallas_interpret.py``): ``qconv2d_ft_stacked`` (``_ft_kernel``
with ``SCHEME10``, forward and dx), ``qconv_chain.chain_layer(...,
scheme="fast10")`` (``_fwd_kernel``, ``_dx_kernel``) and
``qgemm.qgemm_stacked`` (``_qgemm_kernel``, ``_qgemm_dw_kernel``). The CUDA
kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Inputs and cotangents are numpy-seeded, f32. Tolerances: forward rtol/atol
1e-4 (sums of up to 9*128 products in another order: f32 eps 1.2e-7 times
sqrt(n) ~ 4e-6, with margin); gradients 1e-3 relative to each gradient's
largest magnitude, as tests/test_pallas.py:173 holds the TPU kernel's (the
dW sums run over up to a few thousand rows).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.ops.pallas import qconv_chain as jchain
from qasr.ops.pallas import qconv_ft as jft
from qasr_torch.ops.kernels import qconv_dx, qconv_ft, qgemm
from qasr_torch.ops.kernels.qconv_chain import ChainLayerFn, chain_layer, qconv_dw
from tests.pallas_interpret import hlo_interpret

# the package exports a function of the module's name
jqgemm = importlib.import_module("qasr.ops.pallas.qgemm")

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-3


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


def _close_rel(got, want, name, rel=GRAD_REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale, err_msg=name)


# ---------------------------------------------------------------------------
# kernel F: the 10-product stacked conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kernel,t,cin,cout",
    [((3, 3), 16, 8, 16), ((3, 5), 11, 16, 8), ((5, 3), 7, 8, 8), ((3, 3), 33, 8, 12)],
)
def test_qconv_fast10_plain_matches_pallas_interpret(kernel, t, cin, cout):
    """Plain version of kernel F against ``qconv2d_ft_stacked`` (the
    10-product ``_ft_kernel``), interpreted: non-square kernels (kh over T,
    kw over F) and T ragged in the TPU's 32-row tile (33)."""
    rng = np.random.default_rng(sum(kernel) + t)
    x = _rand(rng, 2, 4, 5, t, cin, scale=0.5)
    w = _rand(rng, 4, *kernel, cin, cout, scale=0.2)
    with hlo_interpret():
        want = np.asarray(jft.qconv2d_ft_stacked(jnp.asarray(x), jnp.asarray(w)))
    got = qconv_ft.qconv_ft10(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = qconv_ft.qconv_stacked_plain(_t(x), _t(w), scheme=qconv_ft.SCHEME10)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


@pytest.mark.parametrize("kernel,t", [((3, 5), 12), ((5, 3), 9)])
def test_qconv_fast10_grads_match_pallas_vjp(kernel, t):
    """dx and dW of the 10-product stacked conv: :class:`ChainLayerFn` in
    ``fast10`` without a prologue (kernel G's plain version for dx,
    :func:`qconv_dw` for dW) against ``jax.vjp`` of ``qconv2d_ft_stacked``
    (``_ft_dx_impl`` interpreted, ``_ft_dw_impl``)."""
    rng = np.random.default_rng(t)
    x = _rand(rng, 2, 4, 4, t, 8, scale=0.5)
    w = _rand(rng, 4, *kernel, 8, 16, scale=0.2)
    dz = _rand(rng, 2, 4, 4, t, 16)
    with hlo_interpret():
        want_z, vjp = jax.vjp(jft.qconv2d_ft_stacked, jnp.asarray(x), jnp.asarray(w))
        want_dx, want_dw = vjp(jnp.asarray(dz))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    z = ChainLayerFn.apply(tx, tw, torch.zeros(64), None, "fast10")
    z.backward(_t(dz))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(want_z), **TOL)
    _close_rel(tx.grad, want_dx, "dx")
    _close_rel(tw.grad, want_dw, "dw")


def test_qconv_dx10_plain_and_rotated_match_pallas_dx_role():
    """Kernel G's two references against the TPU's dx role (``_ft_dx_impl``
    with ``SCHEME10``, interpreted): the conv on the conj-transposed weights
    (what kernel G computes) and the TPU's own rotated-role formulation."""
    rng = np.random.default_rng(21)
    dz = _rand(rng, 2, 4, 5, 19, 16)
    w = _rand(rng, 4, 3, 5, 8, 16, scale=0.2)
    with hlo_interpret():
        want = np.asarray(jft._ft_dx_impl(jnp.asarray(dz), jnp.asarray(w), jft.SCHEME10))
    dx, dalpha = qconv_dx.qconv_dx10(_t(dz), _t(w))
    assert dalpha is None
    np.testing.assert_allclose(dx.numpy(), want, **TOL)
    rot = qconv_dx.qconv_dx10_rotated_plain(_t(dz), _t(w))
    np.testing.assert_allclose(rot.numpy(), want, **TOL)


@pytest.mark.parametrize("negative_alpha", [False, True])
def test_qconv_dx10_epilogue_matches_xla_vjp(negative_alpha):
    """Kernel G's plain version with the PReLU backward (dx, dalpha) against
    ``jax.vjp`` of ``qconv_fast10_stacked(prelu(z), w)``; signed slopes."""
    rng = np.random.default_rng(22)
    z = _rand(rng, 2, 4, 3, 10, 8, scale=0.5)
    w = _rand(rng, 4, 3, 3, 8, 16, scale=0.2)
    alpha = _rand(rng, 32, scale=0.25)
    if not negative_alpha:
        alpha = np.abs(alpha)
    dz = _rand(rng, 2, 4, 3, 10, 16)
    jw = jnp.asarray(w)
    _, vjp = jax.vjp(
        lambda zz, a: jft.qconv_fast10_stacked(
            jnp.where(zz >= 0, zz, a.reshape(4, 1, 1, -1) * zz), jw),
        jnp.asarray(z), jnp.asarray(alpha),
    )
    want_dx, want_da = vjp(jnp.asarray(dz))
    dx, dalpha = qconv_dx.qconv_dx10(_t(dz), _t(w), _t(z), _t(alpha))
    _close_rel(dx, want_dx, "dx", rel=1e-4)
    _close_rel(dalpha, want_da, "dalpha", rel=1e-4)


@pytest.mark.parametrize("kernel,negative_alpha,prologue", [((3, 3), True, True), ((5, 3), False, False)])
def test_chain_layer_fast10_matches_pallas_chain(kernel, negative_alpha, prologue):
    """``chain_layer(scheme="fast10")`` forward and VJP against the Pallas
    chain layer with ``scheme="fast10"`` (``_fwd_kernel``, ``_dx_kernel``)
    and chain_entry/chain_exit, interpreted, at its 128-channel tile; T=20
    leaves a ragged tail in its 32-row time tile."""
    t, f, c = 20, 3, 128
    rng = np.random.default_rng(23)
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
        zp = jchain.chain_layer(xp, ww, bb, aa if prologue else None, t_valid=t, scheme="fast10")
        return jchain.chain_exit(zp, f, t, kw)

    with hlo_interpret():
        want_z, vjp = jax.vjp(ref, *map(jnp.asarray, (x, w, bias, alpha)))
        want = vjp(jnp.asarray(dz))
    ts = [_t(a).requires_grad_() for a in (x, w, bias, alpha)]
    z = chain_layer(ts[0], ts[1], ts[2], ts[3] if prologue else None, scheme="fast10")
    z.backward(_t(dz))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(want_z), **TOL)
    # the Function (kernels F and G's plain versions, qconv_dw) gives the same
    fs = [_t(a).requires_grad_() for a in (x, w, bias, alpha)]
    ChainLayerFn.apply(fs[0], fs[1], fs[2], fs[3] if prologue else None, "fast10").backward(_t(dz))
    for name, g, gf, wg in zip(("x", "w", "bias", "alpha"), (t_.grad for t_ in ts),
                               (t_.grad for t_ in fs), want):
        if name == "alpha" and not prologue:
            assert g is None and gf is None
            continue
        _close_rel(g, wg, f"d{name}")
        _close_rel(gf, wg, f"d{name} (ChainLayerFn)")


def test_qconv_dw_fast10_matches_xla_transpose():
    """dW of the 10-product conv alone against ``_ft_dw_impl``."""
    rng = np.random.default_rng(24)
    x = _rand(rng, 2, 4, 4, 13, 8, scale=0.5)
    dz = _rand(rng, 2, 4, 4, 13, 16)
    want = jft._ft_dw_impl(jnp.asarray(x), jnp.asarray(dz), (4, 3, 5, 8, 16), jnp.float32, jft.SCHEME10)
    _close_rel(qconv_dw(_t(x), _t(dz), (3, 5), "fast10"), want, "dw")


# ---------------------------------------------------------------------------
# kernels H and I: the 10-product GEMM and its dW
# ---------------------------------------------------------------------------


def test_gemm_term_tables_match_reference():
    assert qgemm._X_TERMS == jqgemm._X_TERMS
    assert qgemm._OUT_TERMS_OF_P == jqgemm._OUT_TERMS_OF_P
    wt = [[(a, int(qgemm.W_COMBO[p, a])) for a in range(4) if qgemm.W_COMBO[p, a] != 0]
          for p in range(10)]
    assert wt == jqgemm._W_TERMS_OF_P


# (shapes apart from tests/test_pallas.py's: an interpreted pallas_call run again
# through the same cached jit, differentiated otherwise, can hang the process)
@pytest.mark.parametrize("m,k,n", [(64, 40, 24), (300, 130, 88), (7, 256, 62)])
def test_qgemm_plain_matches_pallas_interpret(m, k, n):
    """Plain version of kernel H against ``qgemm_stacked`` (``_qgemm_kernel``,
    interpreted): aligned, everything ragged, tiny M."""
    rng = np.random.default_rng(m + k)
    x4 = _rand(rng, 4, m, k)
    w = _rand(rng, 4, k, n, scale=0.1)
    with hlo_interpret():
        want = np.asarray(jqgemm.qgemm_stacked(jnp.asarray(x4), jnp.asarray(w)))
    np.testing.assert_allclose(qgemm.qgemm_stacked_plain(_t(x4), _t(w)).numpy(), want, **TOL)
    np.testing.assert_allclose(qgemm.qgemm10(_t(x4), _t(w)).numpy(), want, **TOL)


@pytest.mark.parametrize(
    "m,k,n",
    [
        (12, 40, 24),    # M < 256: dW is the 16-product einsum
        (300, 40, 24),   # M >= 256: dW is _qgemm_dw_kernel (kernel I)
    ],
)
def test_qgemm_fn_grads_match_pallas(m, k, n):
    """:class:`QGemmFn` forward, dx (kernel H's plain version on the
    conj-transposed weights) and both dW branches against ``jax.vjp`` of
    ``qgemm_stacked`` (``_qgemm_kernel`` and, at M >= 256,
    ``_qgemm_dw_kernel``, interpreted)."""
    rng = np.random.default_rng(m)
    x4 = _rand(rng, 4, m, k, scale=0.5)
    w = _rand(rng, 4, k, n, scale=0.1)
    dy4 = _rand(rng, 4, m, n)
    with hlo_interpret():
        want_y, vjp = jax.vjp(jqgemm.qgemm_stacked, jnp.asarray(x4), jnp.asarray(w))
        want_dx, want_dw = vjp(jnp.asarray(dy4))
    tx, tw = _t(x4).requires_grad_(), _t(w).requires_grad_()
    y = qgemm.QGemmFn.apply(tx, tw)
    y.backward(_t(dy4))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    _close_rel(tx.grad, want_dx, "dx")
    _close_rel(tw.grad, want_dw, "dw")
    _close_rel(qgemm.qgemm10_dx(_t(dy4), _t(w)), want_dx, "qgemm10_dx")
    # each dW formulation alone, against the TPU's
    want_einsum = jqgemm._dw_einsum(jnp.asarray(x4), jnp.asarray(dy4))
    _close_rel(qgemm.dw_einsum(_t(x4), _t(dy4)), want_einsum, "dw_einsum")
    with hlo_interpret():
        want_pallas = jqgemm._dw_pallas(jnp.asarray(x4), jnp.asarray(dy4))
    _close_rel(qgemm.qgemm_dw_plain(_t(x4), _t(dy4)), want_pallas, "qgemm_dw_plain")


def test_qdense_pallas_matches_pallas_interpret():
    """The packed dense wrapper, leading dims and ragged K and N, forward
    and gradients, against ``qdense_pallas``."""
    rng = np.random.default_rng(31)
    x = _rand(rng, 2, 7, 4 * 13)
    w = _rand(rng, 4, 13, 9, scale=0.3)
    dy = _rand(rng, 2, 7, 36)
    with hlo_interpret():
        want, vjp = jax.vjp(jqgemm.qdense_pallas, jnp.asarray(x), jnp.asarray(w))
        want_dx, want_dw = vjp(jnp.asarray(dy))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = qgemm.qdense_pallas(tx, tw)
    assert got.shape == (2, 7, 36)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(_t(dy))
    _close_rel(tx.grad, want_dx, "dx")
    _close_rel(tw.grad, want_dw, "dw")
    plain = qgemm.qdense_pallas(_t(x), _t(w), plain=True)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "spatial,cin,cout,padding,strides",
    [((11, 9), 16, 8, "SAME", None), ((8, 7), 4, 4, "VALID", None),
     ((12, 10), 8, 8, "VALID", (2, 2)), ((9, 7), 8, 12, "SAME", (2, 1))],
)
def test_qconv2d_pallas_matches_pallas_interpret(spatial, cin, cout, padding, strides):
    """Slice-im2col plus the 10-product GEMM against ``qconv2d_pallas``,
    interpreted: SAME and VALID, strides; forward and the gradients of x
    and w (kernel H's dx role and, at M >= 256, kernel I's plain version)."""
    rng = np.random.default_rng(cin + cout + spatial[0])
    x = _rand(rng, 2, *spatial, 4 * cin, scale=0.5)
    w = _rand(rng, 4, 3, 3, cin, cout, scale=0.2)
    with hlo_interpret():
        want, vjp = jax.vjp(
            lambda xx, ww: jqgemm.qconv2d_pallas(xx, ww, strides=strides, padding=padding),
            jnp.asarray(x), jnp.asarray(w),
        )
        dy = _rand(rng, *want.shape)
        want_dx, want_dw = vjp(jnp.asarray(dy))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = qgemm.qconv2d_pallas(tx, tw, strides=strides, padding=padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(_t(dy))
    _close_rel(tx.grad, want_dx, "dx")
    _close_rel(tw.grad, want_dw, "dw")


# ---------------------------------------------------------------------------
# the wrappers: the plain version only for CPU tensors, no silent fallback
# ---------------------------------------------------------------------------


def _counts():
    return (qconv_ft.qconv_ft10.launches, qconv_dx.qconv_dx10.launches, qgemm.qgemm10.launches,
            qgemm.qgemm10_dx.launches, qgemm.qgemm10_dw.launches)


def test_10_product_kernel_entries_refuse_cpu_tensors():
    """Asking for kernel F, G, H or I without a CUDA tensor raises; the
    wrappers take the plain versions for CPU tensors and count no launch."""
    before = _counts()
    x, ten = torch.zeros(1, 4, 3, 8, 8), qconv_ft.SCHEME10
    with pytest.raises(ValueError, match="CUDA"):
        qconv_ft.qconv_ft_cuda(x, torch.zeros(10, 3, 3, 8, 8), scheme=ten)
    with pytest.raises(ValueError, match=r"wc \[10"):
        qconv_ft.qconv_ft_cuda(x, torch.zeros(8, 3, 3, 8, 8), scheme=ten)
    with pytest.raises(ValueError, match="CUDA"):
        qconv_dx.qconv_dx_cuda(x, torch.zeros(10, 3, 3, 8, 8), scheme=ten)
    with pytest.raises(ValueError, match="kernel G does not support"):
        qconv_dx.qconv_dx_cuda(torch.zeros(1, 4, 3, 8, 12), torch.zeros(10, 3, 3, 12, 8),
                               scheme=ten)
    with pytest.raises(ValueError, match="CUDA"):
        qgemm.qgemm10_cuda(torch.zeros(4, 5, 8), torch.zeros(10, 8, 8))
    with pytest.raises(ValueError, match="multiples of 8"):
        qgemm.qgemm10_cuda(torch.zeros(4, 5, 12), torch.zeros(10, 12, 8))
    with pytest.raises(ValueError, match="CUDA"):
        qgemm.qgemm10_dw_cuda(torch.zeros(4, 5, 8), torch.zeros(4, 5, 8))
    with pytest.raises(TypeError):
        qgemm.qgemm10_dw_cuda(torch.zeros(4, 5, 8).half(), torch.zeros(4, 5, 8).half())
    qconv_ft.qconv_ft10(x, torch.zeros(4, 3, 3, 8, 8))
    qconv_dx.qconv_dx10(x, torch.zeros(4, 3, 3, 8, 8))
    qgemm.qgemm10(torch.zeros(4, 5, 8), torch.zeros(4, 8, 8))
    qgemm.qgemm10_dx(torch.zeros(4, 5, 8), torch.zeros(4, 8, 8))
    qgemm.qgemm10_dw(torch.zeros(4, 300, 8), torch.zeros(4, 300, 8))
    assert _counts() == before
    if not torch.cuda.is_available():
        assert before == (0, 0, 0, 0, 0)
