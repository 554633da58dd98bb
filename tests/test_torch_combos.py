"""The rounding that kernels F and G rely on for their input combos.

Their wgmma loop (``qasr_torch/csrc/qconv.cuh``) forms a two-term X_COMBO
combo as one bf16 addition, ``u + w`` rounded once to bf16, where the
plain version (``qconv_ft._combo``, in bf16 on the CPU) and the loop it
replaced (``form_combos``) add in f32 and then round to bf16. The two agree
for every pair of bf16 values: the f32 sum is exact unless the exponents
differ by more than 16, and then both round to the larger operand. Held
here on pairs drawn across exponent gaps, the exact sum rounded from
float64 in numpy."""

import numpy as np
import pytest
import torch

from qasr_torch.ops.kernels.qconv_ft import SCHEME10, _combo


def _bf16_from_f64(x: np.ndarray) -> np.ndarray:
    """Round to nearest even at bf16's 8 significant bits (normal range)."""
    m, e = np.frexp(x)
    return np.ldexp(np.round(m * 256.0) / 256.0, e)


@pytest.mark.parametrize("gap", [0, 8, 16, 17, 24, 40])
def test_two_term_combo_rounds_once(gap):
    rng = np.random.default_rng(gap)
    n = 200_000
    u = _bf16_from_f64(rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n))
    w = _bf16_from_f64(rng.standard_normal(n) * 2.0 ** (rng.integers(-20, 20, n) - gap))
    once = _bf16_from_f64(u + w)  # exact in float64 for these exponents
    x = torch.zeros(n, 4, dtype=torch.bfloat16)
    x[:, 0] = torch.from_numpy(u.astype(np.float32)).to(torch.bfloat16)
    x[:, 1] = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    terms = SCHEME10.fwd_in[4]  # X_COMBO row 4: x_0 + x_1
    assert terms == ((0, 1.0), (1, 1.0))
    got = _combo(x, terms).double().numpy()
    np.testing.assert_array_equal(got, once)
