"""Kernel J's plain version (``qasr_torch/ops/kernels/dgt.py``) against the
TPU kernel it replaces, ``benchmarks/probe_dgt.py:kern``, in interpret mode.

``benchmarks/probe_dgt.py`` times its kernel when imported, so it is not
imported: its ``make`` function is taken from its source with ``ast`` and run
in a namespace of small shapes (M 512, K = N = 128, G 4 chunks) whose ``pl``
is Pallas with ``pallas_call(..., interpret=True)``. Inputs come from numpy
with a seed.

Tolerances: f32 rel-norm 1e-6 (the TPU kernel sums its G chunks one after
another, the plain version in one product: another order, ~1e-7); bf16
within one bf16 ulp of each element (both sum in f32 and round once, so an
element differs only where the two sums straddle a rounding boundary) and
rel-norm 4e-3.
"""

import ast
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from qasr_torch.ops.kernels import dgt as kdgt
from qasr_torch.ops.kernels import qgemm as kqgemm

torch.set_num_threads(1)
_PROBE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmarks", "probe_dgt.py")
_DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
M, K, N, G = 512, 128, 128, 4


@functools.lru_cache(maxsize=None)
def _tpu_make(m=M, k=K, n=N, g=G):
    """The probe's ``make``, compiled in a namespace of small shapes (M, K,
    N and G chunks of M) and an interpreting ``pallas_call``."""
    tree = ast.parse(open(_PROBE).read(), _PROBE)
    fn = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "make")
    shim = types.SimpleNamespace(**{a: getattr(pl, a) for a in dir(pl) if not a.startswith("_")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = {"jax": jax, "jnp": jnp, "lax": lax, "pl": shim, "pltpu": pltpu,
          "M": m, "K": k, "N": n, "G": g}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), _PROBE, "exec"), ns)
    return ns["make"]


def _inputs(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, K)).astype(np.float32)
    y = rng.standard_normal((M, N)).astype(np.float32)
    tdt, jdt = _DTYPES[dtype]
    xt, yt = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    # the same (rounded) values on both sides
    return (xt, yt, jnp.asarray(xt.float().numpy()).astype(jdt),
            jnp.asarray(yt.float().numpy()).astype(jdt))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    _, e = np.frexp(np.abs(v))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dgt", "plain"])
def test_plain_matches_interpreted_tpu_kernel(mode, dtype):
    """``dgt_plain`` against the probe's Pallas kernel in both modes: ``x
    [M, K]`` contracting rows (``"dgt"``), or pre-transposed to ``[K, M]``
    (``"plain"``)."""
    x, y, jx, jy = _inputs(dtype)
    if mode == "plain":
        x, jx = x.T.contiguous(), jx.T
    want_j = _tpu_make()(mode)(jx, jy)
    assert want_j.dtype == jx.dtype and want_j.shape == (K, N)
    want = np.asarray(want_j.astype(jnp.float32))
    launches = kdgt.dgt.launches
    got_t = kdgt.dgt(x, y, mode=mode)
    assert kdgt.dgt.launches == launches  # the CPU runs no kernel
    assert got_t.dtype == x.dtype and got_t.shape == (K, N)
    got = got_t.float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    if dtype == "float32":
        assert rel <= 1e-6
        return
    ulp = np.maximum(_bf16_ulp(got), _bf16_ulp(want))
    assert np.all(np.abs(got - want) <= ulp)
    assert rel <= 4e-3


def test_modes_agree_and_plain_flag():
    """The two modes give one function of the same data; ``plain=True`` is
    the plain version."""
    x, y, _, _ = _inputs("float32")
    a = kdgt.dgt(x, y, mode="dgt")
    torch.testing.assert_close(kdgt.dgt(x.T.contiguous(), y, mode="plain"), a,
                               rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(kdgt.dgt(x, y, mode="dgt", plain=True), a, rtol=0, atol=0)


def test_supported_and_mode_check():
    """What kernel J takes: f32 or bf16, K and N multiples of 8, and M too
    in ``"plain"`` mode; an unknown mode or shapes that do not contract
    raise."""
    bf16 = torch.bfloat16
    assert kdgt.supported(65536, 256, 256, bf16, "dgt")
    assert kdgt.supported(65536, 256, 256, torch.float32, "plain")
    assert kdgt.supported(1001, 256, 256, bf16, "dgt")  # ragged M: zero-filled rows
    assert not kdgt.supported(1001, 256, 256, bf16, "plain")  # x's rows run along M
    assert not kdgt.supported(512, 250, 256, bf16)
    assert not kdgt.supported(512, 256, 12, bf16)
    assert not kdgt.supported(512, 256, 256, torch.float16)
    assert not kdgt.supported(0, 256, 256, bf16)
    x, y = torch.zeros(16, 8), torch.zeros(16, 8)
    for bad in ("DGT", "rows"):
        with pytest.raises(ValueError, match="unknown mode"):
            kdgt.dgt(x, y, mode=bad)
        with pytest.raises(ValueError, match="unknown mode"):
            kdgt.supported(16, 8, 8, torch.float32, bad)
    with pytest.raises(ValueError, match="do not contract"):
        kdgt.dgt(x, torch.zeros(8, 8), mode="dgt")
    with pytest.raises(ValueError, match="do not contract"):
        kdgt.dgt(x, y, mode="plain")  # x [K=16, M=8] against y's 16 rows
    with pytest.raises(ValueError, match="CUDA"):
        kdgt.dgt_cuda(x, y, mode="dgt")


def _split(kernel, m, k, n, dtype, sms):
    """S, the rows of M a chunk, the (K, N) tile and the blocks resident on
    an SM of a split-M kernel: J (``dgt.j_splits`` with its own parameters,
    dgt.cu) or I (``dgt.splits`` with kernel I's, qgemm10_dw.cu)."""
    if kernel == "J":
        return (kdgt.j_splits(m, k, n, dtype, sms), kdgt._CHUNK[dtype], kdgt._TILE[dtype],
                kdgt._BLOCKS_PER_SM[dtype])
    chunk, tile, per_sm = kqgemm._DW_CHUNK[dtype], kqgemm._DW_TILE, kqgemm._DW_BLOCKS_PER_SM
    return (kdgt.splits(m, k, n, chunk=chunk, tile=tile, blocks_per_sm=per_sm, sms=sms), chunk,
            tile, per_sm)


@pytest.mark.parametrize("kernel", ["I", "J"])
@pytest.mark.parametrize("m,k,n,sms", [(65536, 256, 256, 132), (65536, 256, 256, 114),
                                       (100, 256, 256, 132), (4096, 3328, 256, 132),
                                       (40, 8, 8, 132), (4096, 256, 256, 132),
                                       (53248, 2304, 256, 132), (4096, 4096, 2048, 132)])
def test_splits_cover_m_without_an_empty_run(kernel, m, k, n, sms):
    """The splits of M of kernels J and I: the runs cover M exactly, at most
    one a chunk and none empty; S = 1 where the tiles alone fill a wave. I's
    runs are ceil(chunks / S) chunks long (the last shorter) and its S the
    wave nearest; J shares the chunks out as evenly as whole chunks allow,
    in at most one wave of blocks, S a multiple of its bf16 cluster (a pair)
    where it has that many. Pinned: J at the probe's shape fills one wave
    (bf16: 2 tiles of 128 x 256, one block an SM, so 66 runs on 132 SMs and
    56 on 114; f32: 16 tiles of 64 x 64, four blocks an SM, 33 and 28); I at
    the dense layers' K256 one wave of one block an SM, and at the path's two
    wide shapes one pass."""
    for dtype in (torch.bfloat16, torch.float32):
        s, chunk, tile, per_sm = _split(kernel, m, k, n, dtype, sms)
        chunks = -(-m // chunk)
        tiles = -(-k // tile[0]) * -(-n // tile[1])
        assert 1 <= s <= chunks
        if tiles >= per_sm * sms:
            assert s == 1
        if kernel == "I":
            per = -(-chunks // s)
            assert (s - 1) * per < chunks <= s * per
            assert kqgemm.dw_splits(m, k, n, dtype, sms) == s
        else:
            runs = [(r + 1) * chunks // s - r * chunks // s for r in range(s)]
            assert sum(runs) == chunks and min(runs) >= 1
            assert s == 1 or s * tiles <= per_sm * sms
            cluster = kdgt._CLUSTER[dtype]
            assert s % cluster == 0 or s < cluster
            assert kdgt.partials(s, dtype) == (s // cluster if s % cluster == 0 else s)
    if kernel == "J":
        for dtype, want in ((torch.bfloat16, (66, 56)), (torch.float32, (33, 28))):
            assert (kdgt.j_splits(65536, 256, 256, dtype, 132),
                    kdgt.j_splits(65536, 256, 256, dtype, 114)) == want
    else:  # 16 tiles: 8 x 16 <= 132; 208 and 144 tiles fill a wave alone
        for dtype in (torch.bfloat16, torch.float32):
            assert kqgemm.dw_splits(4096, 256, 256, dtype, 132) == 8
            assert kqgemm.dw_splits(4096, 3328, 256, dtype, 132) == 1
            assert kqgemm.dw_splits(53248, 2304, 256, dtype, 132) == 1


def test_probe_tool_needs_a_card():
    """``python -m qasr_torch.tools.probe_dgt`` times on the card and raises
    without one."""
    from qasr_torch.tools import probe_dgt

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        probe_dgt.main()
