"""``QBatchNorm``, the component getters and the algebra oracles against the
JAX package.

The three cases of ``tests/test_models.py:152-205`` run on both sides at the
same seeded input: the JAX layer's variables (``params`` and the
``batch_stats`` collection) go through ``qasr_torch.bridge`` into the port's
parameters and buffers, and back. Each case holds the outputs, the updated
running statistics and the gradients against the JAX layer's, besides the
reference test's own assertions.

Tolerances: outputs, statistics and gradients 1e-4 relative to the
reference's largest element (f32: a 4x4 Cholesky factor and triangular
solve per channel, and sums over 4096 rows, in another order); the oracles
1e-6 (``hamilton_tensor`` exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.models import layers as jlayers
from qasr.ops import quaternion as jquat
from qasr_torch.bridge import params_from_jax, params_to_jax
from qasr_torch.models import layers
from qasr_torch.ops import quaternion

torch.set_num_threads(1)
REL = 1e-4


def _close(got, want, name, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale, err_msg=name)


def _jax_layer(x, momentum=0.99):
    """The JAX layer's initial variables and one batch-statistics call:
    (vars, y, updated batch_stats), as numpy."""
    m = jlayers.QBatchNorm(momentum=momentum)
    xj = jnp.asarray(x)
    vars_ = m.init(jax.random.PRNGKey(0), xj, use_running_average=False)
    y, upd = jax.jit(lambda v, a: m.apply(v, a, use_running_average=False,
                                          mutable=["batch_stats"]))(vars_, xj)
    return m, jax.tree.map(np.asarray, vars_), np.asarray(y), jax.tree.map(np.asarray, upd)


def _port_layer(vars_, c, momentum=0.99):
    bn = layers.QBatchNorm(c, momentum=momentum, device="cpu")
    bn.load_state_dict(params_from_jax(vars_))
    return bn


def test_initial_state_matches_jax():
    """A fresh port layer holds the JAX layer's initial params and
    batch_stats, and the bridge carries them there and back."""
    _, vars_, _, _ = _jax_layer(np.zeros((8, 12), np.float32))
    fresh = layers.QBatchNorm(3, device="cpu")
    got = params_to_jax(fresh.state_dict())
    assert set(got) == {"params", "batch_stats"}
    for col in ("params", "batch_stats"):
        for k, v in vars_[col].items():
            np.testing.assert_array_equal(got[col][k], v, err_msg=f"{col}/{k}")


def test_whitens_to_identity_covariance():
    rng = np.random.RandomState(0)
    # correlated but FULL-RANK components: random 4x4 mixing per channel
    src = rng.randn(4096, 4, 3).astype(np.float32)
    mix = rng.randn(3, 4, 4).astype(np.float32) + 2 * np.eye(4)[None]
    x = (np.einsum("nac,cba->nbc", src, mix)
         + rng.randn(3, 4)[None].transpose(0, 2, 1)).reshape(4096, 12).astype(np.float32)
    _, vars_, want, upd = _jax_layer(x)
    bn = _port_layer(vars_, 3).train()
    y = bn(torch.from_numpy(x))
    _close(y, want, "y")
    _close(bn.mean, upd["batch_stats"]["mean"], "mean")
    _close(bn.cov, upd["batch_stats"]["cov"], "cov")
    ys = y.detach().numpy().reshape(-1, 4, 3)
    for c in range(3):
        comp = ys[:, :, c]
        # gamma=0.5*I on whitened unit components -> cov = 0.25 I
        np.testing.assert_allclose(np.cov(comp.T), 0.25 * np.eye(4), atol=0.02)
        np.testing.assert_allclose(comp.mean(axis=0), 0.0, atol=0.02)


def test_running_stats_update_and_inference():
    x = (np.random.RandomState(1).randn(512, 8).astype(np.float32) * 3 + 1)
    m, vars_, want, upd = _jax_layer(x, momentum=0.0)  # adopt batch stats immediately
    bn = _port_layer(vars_, 2, momentum=0.0)
    y = bn(torch.from_numpy(x), use_running_average=False)
    _close(y, want, "y")
    _close(bn.mean, upd["batch_stats"]["mean"], "mean")
    _close(bn.cov, upd["batch_stats"]["cov"], "cov")
    bn.eval()  # eval mode normalises by the running statistics
    y_inf = bn(torch.from_numpy(x))
    back = params_to_jax(bn.state_dict())
    want_inf = jax.jit(lambda v, a: m.apply(v, a, use_running_average=True))(back, jnp.asarray(x))
    _close(y_inf, want_inf, "y_inf")
    np.testing.assert_allclose(y.detach().numpy(), y_inf.detach().numpy(), atol=1e-3)


@pytest.mark.parametrize("loss_kind", ["square", "projection"])
def test_grads_flow(loss_kind):
    """The reference's ``sum(y**2)``, whose gradients in beta and x vanish
    (whitened y has zero mean and a fixed norm: both sides give f32 noise
    there, so only gamma's is compared), and ``sum(y * r)`` with a seeded
    ``r``, whose every gradient is compared."""
    rng = np.random.RandomState(2)
    x = rng.randn(64, 8).astype(np.float32)
    r = rng.randn(64, 8).astype(np.float32)
    m, vars_, _, _ = _jax_layer(x)

    def loss(p, xx):
        y, _ = m.apply({"params": p, "batch_stats": vars_["batch_stats"]}, xx,
                       use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y ** 2) if loss_kind == "square" else jnp.sum(y * r)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(vars_["params"], jnp.asarray(x))
    bn = _port_layer(vars_, 2).train()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y.square().sum() if loss_kind == "square" else (y * torch.from_numpy(r)).sum()).backward()
    for name in ("gamma", "beta"):
        assert torch.isfinite(getattr(bn, name).grad).all()
    _close(bn.gamma.grad, gp["gamma"], "gamma")
    if loss_kind == "projection":
        _close(bn.beta.grad, gp["beta"], "beta")
        _close(xt.grad, gx, "dx")


def test_getters_and_oracles_match_jax():
    """``get_r..k``, ``hamilton_tensor`` and ``qdense_naive`` (f32, and its
    gradient) against the JAX package's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 4 * 6)).astype(np.float32)
    w = rng.standard_normal((4, 6, 7)).astype(np.float32)
    for name in ("get_r", "get_i", "get_j", "get_k"):
        np.testing.assert_array_equal(getattr(layers, name)(torch.from_numpy(x)).numpy(),
                                      np.asarray(getattr(jlayers, name)(jnp.asarray(x))))
    np.testing.assert_array_equal(quaternion.hamilton_tensor(), jquat.hamilton_tensor())
    want = jax.jit(jquat.qdense_naive)(jnp.asarray(x), jnp.asarray(w))
    gw = jax.jit(jax.grad(lambda ww: jnp.sum(jquat.qdense_naive(jnp.asarray(x), ww) ** 2)))(
        jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    got = quaternion.qdense_naive(torch.from_numpy(x), wt)
    _close(got, want, "qdense_naive", rel=1e-6)
    got.square().sum().backward()
    _close(wt.grad, gw, "qdense_naive dw", rel=1e-5)
    # the oracle agrees with the block path
    block = torch.from_numpy(x) @ quaternion.hamilton_expand(torch.from_numpy(w))
    _close(got, block.numpy(), "naive vs block", rel=1e-5)


@pytest.mark.parametrize("scheme", ["U8", "W_COMBO"])
def test_hamilton_tensor_is_what_the_schemes_decompose(scheme):
    """The rank-8 and 10-product tables reproduce ``hamilton_tensor``."""
    t = quaternion.hamilton_tensor()
    if scheme == "U8":
        u, v, o = quaternion.U8, quaternion.V8, quaternion.O8
    else:
        u, v, o = quaternion.W_COMBO, quaternion.X_COMBO, quaternion.OUT_COMBO
    np.testing.assert_allclose(np.einsum("pi,pj,kp->ijk", u, v, o), t, atol=1e-12)
