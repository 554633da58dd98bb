"""The stacked conv's weight gradient and what kernel K makes for it
(``ops/kernels/qconv_dw_prep.py``, ``csrc/qconv_dw_prep.cu``), on the CPU.

On the CPU :func:`qconv_dw` takes K's plain version: held here, with the
PReLU of the previous layer folded in or not, against the JAX package's
``_ft_dw_impl`` (the linear transpose of its XLA conv, which left dW to
XLA) in the rank-8 and the 10-product scheme, and its db against the sum of
dz. The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``). Its compiled-in scheme tables are read from
its source and held to ``SCHEMES``' V and O as the wrappers hand them over.

Inputs and cotangents are numpy-seeded, f32. Tolerance: 1e-3 relative to
each gradient's largest magnitude, as tests/test_torch_fast10.py holds dW
(sums over a few hundred rows in another order).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr.ops.pallas import qconv_ft as jft
from qasr_torch.ops.kernels import qconv_dw_prep as kprep
from qasr_torch.ops.kernels.qconv_chain import qconv_dw
from qasr_torch.ops.kernels.qconv_ft import _TABLES, SCHEMES, _coef

torch.set_num_threads(1)
REL = 1e-3
_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "qasr_torch", "csrc", "qconv_dw_prep.cu")
_JAX_SCHEMES = {"fast8": jft.SCHEME8, "fast10": jft.SCHEME10}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close_rel(got, want, name):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * scale, err_msg=name)


# the 10-product scheme without a PReLU: tests/test_torch_fast10.py
@pytest.mark.parametrize("scheme,prologue,kernel", [
    ("fast8", False, (3, 3)), ("fast8", True, (3, 5)), ("fast10", True, (3, 3)),
])
def test_qconv_dw_plain_matches_xla_transpose(scheme, prologue, kernel):
    """dW and db through :func:`qconv_dw` (K's plain version on the CPU)
    against ``_ft_dw_impl`` on the activated input, T ragged (13)."""
    rng = np.random.default_rng(31 + len(scheme) + prologue)
    cin, cout = 8, 16
    x = _rand(rng, 2, 4, 4, 13, cin, scale=0.5)
    dz = _rand(rng, 2, 4, 4, 13, cout)
    alpha = _rand(rng, 4 * cin, scale=0.25) if prologue else None
    x_act = x
    if prologue:
        x_act = np.where(x >= 0, x, alpha.reshape(4, 1, 1, cin) * x)
    want = jft._ft_dw_impl(jnp.asarray(x_act), jnp.asarray(dz), (4, *kernel, cin, cout),
                           jnp.float32, _JAX_SCHEMES[scheme])
    before = kprep.qconv_dw_prep.launches
    dw, db = qconv_dw(torch.from_numpy(x), torch.from_numpy(dz), kernel, scheme,
                      None if alpha is None else torch.from_numpy(alpha))
    assert kprep.qconv_dw_prep.launches == before  # no kernel on the CPU
    assert dw.dtype == db.dtype == torch.float32
    _close_rel(dw, want, "dw")
    _close_rel(db, dz.sum(axis=(0, 2, 3)).reshape(-1), "db")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_prep_layout_and_combos(dtype):
    """K's plain version: ``[P,B,F,T,C]`` combos in the compute dtype, each
    input combo the previous layer's PReLU then ``_combo``'s terms, each
    output combo the scheme's column of O over dz's components, db in f32."""
    rng = np.random.default_rng(37)
    x = torch.from_numpy(_rand(rng, 2, 4, 3, 5, 8)).to(dtype)
    dz = torch.from_numpy(_rand(rng, 2, 4, 3, 5, 16)).to(dtype)
    alpha = torch.from_numpy(_rand(rng, 32, scale=0.25))
    for name, sc in SCHEMES.items():
        xc, dzc, db = kprep.qconv_dw_prep(x, dz, alpha, scheme=sc)
        assert xc.shape == (sc.n_prods, 2, 3, 5, 8) and xc.dtype == dtype
        assert dzc.shape == (sc.n_prods, 2, 3, 5, 16) and dzc.dtype == dtype
        assert db.shape == (64,) and db.dtype == torch.float32
        act = torch.where(x >= 0, x, alpha.to(dtype).reshape(4, 1, 1, 8) * x)
        want_x = np.einsum("pa,bafti->pbfti", sc.v_mat, act.double().numpy())
        want_z = np.einsum("ap,bafti->pbfti", sc.o_mat, dz.double().numpy())
        tol = 1e-6 if dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(xc.double().numpy(), want_x, rtol=tol, atol=tol, err_msg=name)
        np.testing.assert_allclose(dzc.double().numpy(), want_z, rtol=tol, atol=tol, err_msg=name)
        np.testing.assert_allclose(db.numpy(), dz.double().sum(dim=(0, 2, 3)).reshape(-1).numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _compiled_table(source: str, fn: str, p: int) -> np.ndarray:
    """The f32 table that ``fn<p>`` returns in the kernel's source."""
    m = re.search(rf"constexpr float {fn}<{p}>\(int \w+, int \w+\) \{{\s*constexpr float "
                  rf"t\[(\d+)\]\[(\d+)\] = \{{(.*?)\}};", source, re.S)
    assert m, f"{fn}<{p}> not found in {_SOURCE}"
    rows, cols = int(m.group(1)), int(m.group(2))
    vals = [float(v) for v in re.findall(r"(-?\d+\.\d*(?:e-?\d+)?)f", m.group(3))]
    assert len(vals) == rows * cols, (fn, p, len(vals))
    return np.array(vals, np.float32).reshape(rows, cols)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_compiled_scheme_tables_match_schemes(scheme):
    """K compiles each scheme in and refuses host tables that differ from
    it: the compiled V and O equal, bit for bit, the f32 tables the wrapper
    hands over (``_TABLES``, from ``SCHEMES[...]``'s V and O). A coefficient
    that K rounds to bf16 from its f32 value is the one ``_combo`` rounds
    from the float64 table."""
    with open(_SOURCE) as f:
        source = f.read()
    sc = SCHEMES[scheme]
    p = sc.n_prods
    v_tab, o_tab = _TABLES[scheme]
    v = _compiled_table(source, "v_tab", p)
    o = _compiled_table(source, "o_tab", p)
    np.testing.assert_array_equal(v, v_tab)
    np.testing.assert_array_equal(o, o_tab)
    np.testing.assert_array_equal(v, sc.v_mat.astype(np.float32))
    np.testing.assert_array_equal(o, sc.o_mat.astype(np.float32))
    for c64, c32 in zip(sc.v_mat.flat, v.flat):
        if c64 != 0:
            assert torch.tensor(float(c32)).to(torch.bfloat16).item() == _coef(c64, torch.bfloat16)
