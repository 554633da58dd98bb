"""The packed XLA conv arms, the 10-product and stacked-entry dense layers,
the stacked XLA entry points and the expanded-conv oracle against the JAX
package; and ``op_variant`` fast, fast10, fast8 and legacy_auto through
``build_model`` against the JAX model at bridged weights.

The JAX package runs every one of these on plain XLA
(``qasr/ops/qlinalg.py:106-430``, ``qasr/ops/pallas/qconv_ft.py:475-487``),
so the port runs them on library ops: no kernel of the port is on these
paths. Each function gets the same seeded numpy inputs on both sides (the
JAX side one jitted computation: the output and the vjp of a seeded
cotangent), with (3, 5) and (5, 3) kernels for the convs.

Tolerances, each relative to the reference's largest element: f32 1e-5
(outputs and gradients; sums in another order); bf16 2e-2 for outputs and
4e-2 for gradients (about five bf16 ulps at the peak: XLA keeps an
elementwise bf16 chain in f32 between its roundings and the stacked XLA
arm returns bf16 products, where PyTorch rounds every op and the port's
stacked plain version keeps its products in f32 until the fold). The
models: f32 logits rtol/atol 1e-4, as ``tests/test_torch_fast10_model.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.configs import get_config as jget_config
from qasr.ops import qlinalg as jq
from qasr.ops.pallas import qconv_ft as jft
from qasr.train.state import build_model as jbuild_model
from qasr_torch.bridge import params_to_jax
from qasr_torch.configs import get_config
from qasr_torch.models import build_model
from qasr_torch.models.qcnn import conv_scheme
from qasr_torch.ops import qlinalg
from qasr_torch.ops.kernels import qconv_ft

torch.set_num_threads(1)

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 4e-2)}

# name -> (JAX function, port function)
_PACKED = {
    "qconv_fast": (jq.qconv_fast, qlinalg.qconv_fast),
    "qconv_fast10": (jq.qconv_fast10, qlinalg.qconv_fast10),
    "qconv_fast8": (jq.qconv_fast8, qlinalg.qconv_fast8),
}
_STACKED = {
    "qconv_fast8_stacked": (jft.qconv_fast8_stacked, qconv_ft.qconv_fast8_stacked),
    "qconv_fast10_stacked": (jft.qconv_fast10_stacked, qconv_ft.qconv_fast10_stacked),
}
B, T, F_, CIN, COUT = 2, 9, 7, 8, 16


def _inputs(x_shape, w_shape, y_shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) / np.sqrt(np.prod(w_shape[1:-1]))).astype(np.float32)
    dy = rng.standard_normal(y_shape).astype(np.float32)
    return x, w, dy


def _jax_vjp(fn, x, w, dy, jdt):
    """The JAX function's output and its vjp of ``dy`` in x and w, jitted;
    returned as f32 numpy."""

    @jax.jit
    def run(xj, wj, dyj):
        y, vjp = jax.vjp(fn, xj, wj)
        return (y,) + vjp(dyj.astype(y.dtype))

    out = run(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(dy))
    return [np.asarray(o.astype(jnp.float32)) for o in out]


def _port_vjp(fn, x, w, dy, tdt):
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    y = fn(xt, wt)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    return [t.detach().float().numpy() for t in (y, xt.grad, wt.grad)]


def _close(got, want, rel, name):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale, err_msg=name)


def _check(jfn, tfn, x, w, dy, dtype, *, y_bf16=None):
    """``tfn`` against ``jfn`` in ``dtype``. ``y_bf16``: XLA's CPU backend
    runs a ``preferred_element_type=f32`` dot of bf16 operands only on 2-D
    operands (its thunk refuses the transposed and batched ones), so the
    dense layers' bf16 output is held against ``y_bf16`` (the JAX function
    on a 2-D view) and their bf16 gradients against the JAX vjp in f32 on
    the same bf16-rounded inputs."""
    jdt, tdt = _DTYPES[dtype]
    y_tol, g_tol = _TOL[dtype]
    if y_bf16 is not None:
        rounded = [np.asarray(jnp.asarray(a, jdt).astype(jnp.float32)) for a in (x, w)]
        want = [y_bf16, *_jax_vjp(jfn, *rounded, dy, jnp.float32)[1:]]
    else:
        want = _jax_vjp(jfn, x, w, dy, jdt)
    got = _port_vjp(tfn, x, w, dy, tdt)
    assert got[0].shape == want[0].shape
    for g, r, name, tol in zip(got, want, ("y", "dx", "dw"), (y_tol, g_tol, g_tol)):
        _close(g, r, tol, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", [(3, 5), (5, 3)])
@pytest.mark.parametrize("name", [*_PACKED, *_STACKED])
def test_conv_arm_matches_jax(name, kernel, dtype):
    """Each conv arm, forward and both gradients, against its JAX
    counterpart: packed ``[B, T, F, 4 Cin]`` for the packed arms, stacked
    ``[B, 4, F, T, Cin]`` for the stacked entry points (their custom VJP on
    the JAX side, autograd of the plain version here)."""
    kh, kw = kernel
    if name in _PACKED:
        jfn, tfn = _PACKED[name]
        shapes = ((B, T, F_, 4 * CIN), (4, kh, kw, CIN, COUT), (B, T, F_, 4 * COUT))
    else:
        jfn, tfn = _STACKED[name]
        shapes = ((B, 4, F_, T, CIN), (4, kh, kw, CIN, COUT), (B, 4, F_, T, COUT))
    x, w, dy = _inputs(*shapes, seed=kh * 10 + kw)
    _check(jfn, tfn, x, w, dy, dtype)


@pytest.mark.parametrize("kernel", [(3, 5), (5, 3)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_expanded_oracle_matches_jax(kernel, padding):
    """The expanded-conv oracle (f32 only, as the reference's) and the
    packed arms at VALID padding against it."""
    kh, kw = kernel
    x, w, _ = _inputs((B, T, F_, 4 * CIN), (4, kh, kw, CIN, COUT), (1,), seed=7)
    want = np.asarray(jax.jit(lambda a, b: jq.qconv_expanded_oracle(a, b, padding=padding))(
        jnp.asarray(x), jnp.asarray(w)))
    got = qlinalg.qconv_expanded_oracle(torch.from_numpy(x), torch.from_numpy(w),
                                        padding=padding)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5, "oracle")
    for name, (_, tfn) in _PACKED.items():
        arm = tfn(torch.from_numpy(x), torch.from_numpy(w), padding=padding)
        _close(arm.numpy(), want, 1e-5, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdense_fast_matches_jax(dtype):
    """The 10-product dense layer: forward and gradients against
    ``qasr.ops.qlinalg.qdense_fast``."""
    x, w, dy = _inputs((3, 5, 4 * 24), (4, 24, 12), (3, 5, 4 * 12), seed=11)
    y_bf16 = None
    if dtype == "bfloat16":
        y_bf16 = _jax_2d(jq.qdense_fast, x.reshape(15, -1), w).reshape(3, 5, -1)
    _check(jq.qdense_fast, qlinalg.qdense_fast, x, w, dy, dtype, y_bf16=y_bf16)


def _jax_2d(fn, x2, w):
    """The JAX dense function on bf16 2-D ``x2`` and bf16 ``w``, as f32."""
    y = jax.jit(fn)(jnp.asarray(x2, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdense_fast8_from_stacked_matches_jax(dtype):
    """The rank-8 dense layer on the chain's stacked ``[B, 4, F, T, C]``
    output (K = F*C, F-major): forward and gradients against the JAX
    package's (in bf16 its output against JAX's ``qdense_fast8`` on the
    exit-transposed input, the same function by the reference's own
    account); and equal to the port's ``qdense_fast8`` there."""
    f, c = 3, 8
    x, w, dy = _inputs((B, 4, f, T, c), (4, f * c, 12), (B, T, 4 * 12), seed=12)
    packed_np = x.transpose(0, 3, 1, 2, 4).reshape(B * T, 4 * f * c)
    y_bf16 = None
    if dtype == "bfloat16":
        y_bf16 = _jax_2d(jq.qdense_fast8, packed_np, w).reshape(B, T, -1)
    _check(jq.qdense_fast8_from_stacked, qlinalg.qdense_fast8_from_stacked, x, w, dy, dtype,
           y_bf16=y_bf16)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    packed = torch.from_numpy(packed_np).reshape(B, T, 4 * f * c)
    _close(qlinalg.qdense_fast8_from_stacked(xt, wt).numpy(),
           qlinalg.qdense_fast8(packed, wt).numpy(), 1e-6, "stacked vs packed")


# a thin layer, then one of 128 -> 128 quaternion channels: legacy_auto
# routes the second to fast10 and the first to the block path
_MODEL = {
    "model.conv_features": (8, 128, 128),
    "model.dense_features": (16,),
    "model.compute_dtype": "float32",
    "model.dropout_rate": 0.0,
    "data.n_mels": 8,
}


@pytest.mark.parametrize("op_variant", ["fast", "fast10", "fast8", "legacy_auto"])
def test_packed_variant_model_matches_jax(op_variant):
    """``build_model`` with each packed arm against the JAX model's eval
    logits at bridged weights (the port's, carried to JAX); every layer packed, on the arm the JAX
    QConv picks (legacy_auto: fast10 where min(Cin, features) >= 128), and
    ``conv_scheme`` no longer raises."""
    over = {**_MODEL, "model.op_variant": op_variant}
    jcfg = jget_config("tiny_synthetic").override(**over)
    tcfg = get_config("tiny_synthetic").override(**over)
    assert conv_scheme(op_variant) is None
    x = np.random.default_rng(5).standard_normal((2, 12, 8, 4)).astype(np.float32)
    # the port draws the weights (the JAX init's jit alone takes ~6 s here)
    model = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    arms = ["block", "block", "fast10"] if op_variant == "legacy_auto" else [op_variant] * 3
    assert [model.qconv_0.arm, model.qconv_1.arm, model.qconv_2.arm] == arms
    assert not any(model.stacked)
    jmodel = jbuild_model(jcfg)
    want = jax.jit(lambda p, xx: jmodel.apply({"params": p}, xx, train=False))(
        params_to_jax(model.state_dict()), jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
