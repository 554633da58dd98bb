"""The rounding of the conv and GEMM kernels' input combos, in bf16.

Two rules, one a scheme:

- The 10-product scheme (kernels F and G). Their wgmma loop
  (``qasr_torch/csrc/qconv.cuh``) forms a two-term X_COMBO combo as one bf16
  addition, ``u + w`` rounded once to bf16, where the plain version
  (``qconv_ft._combo``, in bf16 on the CPU) adds in f32 and then rounds to
  bf16. The two agree for every pair of bf16 values: the f32 sum is exact
  unless the exponents differ by more than 16, and then both round to the
  larger operand.
- The rank-8 scheme (kernels A, B and C), whose V8 coefficients are not 1.
  The JAX package forms a combo with ``_scaled``
  (``qasr/ops/pallas/qconv_ft.py``, ``qasr/ops/pallas/qgemm8.py``): each
  coefficient rounded to bf16, each scaled term rounded once, then the
  terms added and the sum rounded once. The port's plain versions
  (``qconv_ft._combo``, ``qgemm8.combos8``) equal it bit for bit, and the
  kernels' ``combo2`` (``qasr_torch/csrc/qtile.cuh``) does the same
  arithmetic, emulated here from float64.

Held on values drawn across exponent gaps, the exact results rounded from
float64 in numpy; then the bf16 plain conv and GEMM against the JAX
package's Pallas kernels in interpret mode at a small size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.ops.pallas import qconv_ft as jft
from qasr.ops.pallas import qgemm8 as jgemm
from qasr_torch.ops.kernels import qconv_ft, qgemm8
from qasr_torch.ops.kernels.qconv_ft import SCHEME8, SCHEME10, _combo
from tests.pallas_interpret import hlo_interpret

torch.set_num_threads(1)


def _bf16_from_f64(x: np.ndarray) -> np.ndarray:
    """Round to nearest even at bf16's 8 significant bits (normal range)."""
    m, e = np.frexp(x)
    return np.ldexp(np.round(m * 256.0) / 256.0, e)


def _spread(rng, n: int, shift: int = 0) -> np.ndarray:
    """n bf16 values (as float64) of both signs over 2^-20 .. 2^20, times 2^-shift."""
    return _bf16_from_f64(rng.standard_normal(n) * 2.0 ** (rng.integers(-20, 20, n) - shift))


def _bf16_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("gap", [0, 8, 16, 17, 24, 40])
def test_two_term_combo_rounds_once(gap):
    rng = np.random.default_rng(gap)
    n = 200_000
    u = _spread(rng, n)
    w = _spread(rng, n, gap)
    once = _bf16_from_f64(u + w)  # exact in float64 for these exponents
    x = torch.zeros(n, 4, dtype=torch.bfloat16)
    x[:, 0] = _bf16_tensor(u)
    x[:, 1] = _bf16_tensor(w)
    terms = SCHEME10.fwd_in[4]  # X_COMBO row 4: x_0 + x_1
    assert terms == ((0, 1.0), (1, 1.0))
    got = _combo(x, terms).double().numpy()
    np.testing.assert_array_equal(got, once)


@pytest.mark.parametrize("gap", [0, 8, 17, 40])
@pytest.mark.parametrize("p", range(8))
def test_rank8_combo_rule(p, gap):
    """``combo2``'s arithmetic, from float64: the coefficients rounded to
    bf16, each product rounded once (exact in float64: 8 x 8 significant
    bits), the sum of the two rounded once (exact in float64 for these
    exponents); ``_combo`` gives the same bits."""
    rng = np.random.default_rng(100 * p + gap)
    n = 50_000
    (a1, c1), (a2, c2) = SCHEME8.fwd_in[p]
    u, w = _spread(rng, n), _spread(rng, n, gap)
    if p % 2:  # the larger operand on either side
        u, w = w, u
    t1 = _bf16_from_f64(u * _bf16_from_f64(np.float64(c1)))
    t2 = _bf16_from_f64(w * _bf16_from_f64(np.float64(c2)))
    want = _bf16_from_f64(t1 + t2)
    x = torch.zeros(n, 4, dtype=torch.bfloat16)
    x[:, a1] = _bf16_tensor(u)
    x[:, a2] = _bf16_tensor(w)
    got = _combo(x, SCHEME8.fwd_in[p]).double().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", range(8))
def test_rank8_conv_combo_matches_jax(p):
    """The plain conv's combo of V8's product p (``qconv_ft._combo`` on the
    stacked layout) against ``qasr/ops/pallas/qconv_ft.py:_scaled``'s,
    jitted on the CPU, bit for bit."""
    assert jft.SCHEME8.fwd_in == SCHEME8.fwd_in
    rng = np.random.default_rng(p)
    x = (rng.standard_normal((2, 4, 5, 40, 64)) * 2.0 ** rng.integers(-6, 6, (2, 4, 5, 40, 64)))
    x = x.astype(np.float32)

    @jax.jit
    def combo(xs):
        out = None
        for a, c in jft.SCHEME8.fwd_in[p]:
            t = jft._scaled(xs[:, a], c)
            out = t if out is None else out + t
        return out

    # bf16 out of the jitted function (a cast to f32 inside it would let XLA
    # skip the sum's rounding)
    want = np.asarray(combo(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = _combo(_bf16_tensor(x), SCHEME8.fwd_in[p]).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,k", [(300, 64), (7, 13)])
def test_rank8_gemm_combos_match_jax(m, k):
    """``qgemm8.combos8`` (the input combos of ``qgemm8_cl_plain``, forward
    and dx role) against ``_qgemm8_kernel``'s (``_FWD_IN``, ``_scaled``,
    first term then the rest), jitted on the CPU, bit for bit."""
    assert jgemm._FWD_IN == SCHEME8.fwd_in
    rng = np.random.default_rng(m + k)
    x4 = (rng.standard_normal((4, m, k)) * 2.0 ** rng.integers(-6, 6, (4, m, k)))
    x4 = x4.astype(np.float32)

    @jax.jit
    def combos(xs):
        out = []
        for terms in jgemm._FWD_IN:
            cmb = jgemm._scaled(xs[terms[0][0]], terms[0][1])
            for a, c in terms[1:]:
                cmb = cmb + jgemm._scaled(xs[a], c)
            out.append(cmb)
        return jnp.stack(out)

    want = np.asarray(combos(jnp.asarray(x4, jnp.bfloat16)).astype(jnp.float32))
    got = qgemm8.combos8(_bf16_tensor(x4)).float().numpy()
    np.testing.assert_array_equal(got, want)


def _within(got: np.ndarray, want: np.ndarray, rel_norm: float, max_rel: float) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= rel_norm * np.linalg.norm(want)
    assert np.abs(got - want).max() <= max_rel * np.abs(want).max()


# bf16 plain path against the Pallas kernel on the same bf16 inputs: the
# combos agree bit for bit, the products sum in f32 in another order and both
# round the output, so a few outputs differ by one bf16 ulp
# (tests/test_torch_rank8_f32.py counts them); the limits here are
# chip_smoke.py's TOL_BF16: rel-norm 1e-2, largest error 5e-2 of the largest
# output
BF16_TOL = dict(rel_norm=1e-2, max_rel=5e-2)


def test_bf16_plain_conv_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((1, 4, 5, 32, 128)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((4, 3, 3, 128, 128)) * 0.05).astype(np.float32)
    with hlo_interpret():
        want = jft.qconv2d_ft8_stacked(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    want = np.asarray(want.astype(jnp.float32))
    got = qconv_ft.qconv_ft8(_bf16_tensor(x), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    _within(got.float().numpy(), want, **BF16_TOL)


def test_bf16_plain_gemm_matches_pallas_interpret():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((12, 4 * 128)).astype(np.float32)
    w = (rng.standard_normal((4, 128, 128)) * 0.1).astype(np.float32)
    with hlo_interpret():
        want = jgemm.qdense_pallas8(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    want = np.asarray(want.astype(jnp.float32))
    got = qgemm8.qdense_pallas8(_bf16_tensor(x), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    _within(got.float().numpy(), want, **BF16_TOL)
