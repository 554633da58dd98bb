"""The partition kernel J uses on the card, emulated on the CPU.

Kernel J (``csrc/dgt.cu``) splits M into S runs of whole chunks
(``dgt.j_splits``: one wave of blocks, the chunks shared out as evenly as
whole chunks allow), and each block sums its output tile over its run's
chunks in order into an f32 partial. In bf16 a cluster pairs two runs
where S is even and adds their partials in shared memory; a second pass
sums the partials in ascending order and casts once. The emulation below
runs that partition in torch f32, 16 rows of M at a time as the tensor
cores step, and is held against the plain version (``dgt_plain``) and
against the TPU kernel it replaces, ``benchmarks/probe_dgt.py:kern``,
interpreted as ``tests/test_torch_dgt.py`` runs it, at M 512 K = N = 128
and a ragged M 1000 K 72 N 40, both modes, f32 and bf16.

Tolerances as ``tests/test_torch_dgt.py``'s: f32 rel-norm 1e-6 (sums in
another order); bf16 within one bf16 ulp of each element (every side sums
in f32 and rounds once) and rel-norm 4e-3.

The file also holds the split's parameters in ``dgt.py`` to the constants
the kernel is compiled with, read from its source.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_torch.ops.kernels import dgt as kdgt
from tests.test_torch_dgt import _bf16_ulp, _tpu_make

torch.set_num_threads(1)
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "qasr_torch",
                     "csrc")
_DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
_STEP = 16  # rows of M a tensor-core step
_SMS = 132


def _partition(x: torch.Tensor, y: torch.Tensor, sms: int = _SMS) -> torch.Tensor:
    """``x^T y`` (x ``[M, K]``) as kernel J sums it on ``sms`` SMs: run r of
    S holds chunks [r C / S, (r + 1) C / S) of the C chunks of M, summed in
    f32 in order; pairs of runs added (bf16, S even); the partials summed in
    ascending order; one cast."""
    m, k = x.shape
    n = y.shape[1]
    dtype = x.dtype
    chunk = kdgt._CHUNK[dtype]
    chunks = -(-m // chunk)
    s = kdgt.j_splits(m, k, n, dtype, sms)
    xf, yf = x.float(), y.float()
    runs = []
    for r in range(s):
        acc = torch.zeros(k, n)
        for c in range(r * chunks // s, (r + 1) * chunks // s):
            for m0 in range(c * chunk, min((c + 1) * chunk, m), _STEP):
                acc = acc + xf[m0:m0 + _STEP].T @ yf[m0:m0 + _STEP]
        runs.append(acc)
    pair = kdgt._CLUSTER[dtype]
    if s % pair == 0 and pair > 1:
        runs = [runs[i] + runs[i + 1] for i in range(0, s, 2)]
    assert len(runs) == kdgt.partials(s, dtype)
    out = runs[0]
    for p in runs[1:]:
        out = out + p
    return out.to(dtype)


def _inputs(m, k, n, dtype):
    rng = np.random.default_rng(13)
    tdt, _ = _DTYPES[dtype]
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(tdt)
    y = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(tdt)
    return x, y


def _close(got: torch.Tensor, want: np.ndarray, dtype: str) -> None:
    g = got.float().numpy()
    rel = np.linalg.norm(g - want) / np.linalg.norm(want)
    if dtype == "float32":
        assert rel <= 1e-6
        return
    assert np.all(np.abs(g - want) <= np.maximum(_bf16_ulp(g), _bf16_ulp(want)))
    assert rel <= 4e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dgt", "plain"])
@pytest.mark.parametrize("m,k,n", [(512, 128, 128), (1000, 72, 40)])
def test_partition_matches_plain_and_tpu_kernel(m, k, n, mode, dtype):
    """The emulated partition against ``dgt_plain`` and the probe's Pallas
    kernel (G = 4 chunks of M) in ``mode``; the two modes feed kernel J the
    same operands, so one emulation stands for both."""
    x, y = _inputs(m, k, n, dtype)
    got = _partition(x, y)
    assert got.dtype == x.dtype and got.shape == (k, n)
    xm = x if mode == "dgt" else x.T.contiguous()
    _close(got, kdgt.dgt_plain(xm, y, mode=mode).float().numpy(), dtype)
    jdt = _DTYPES[dtype][1]
    jx = jnp.asarray(xm.float().numpy()).astype(jdt)
    jy = jnp.asarray(y.float().numpy()).astype(jdt)
    want = _tpu_make(m, k, n, 4)(mode)(jx, jy)
    assert want.dtype == jx.dtype
    _close(got, np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m,k,n", [(65536, 256, 256), (65576, 264, 136), (512, 128, 128),
                                   (1000, 72, 40), (40, 8, 8), (4096, 512, 520)])
def test_j_splits_cover_m_in_one_wave(m, k, n, sms):
    """Kernel J's runs cover M exactly, none empty, in at most one wave of
    its blocks on ``sms`` SMs (132: the H100 SXM; 114: the PCIe card)."""
    for dtype in (torch.bfloat16, torch.float32):
        s = kdgt.j_splits(m, k, n, dtype, sms)
        chunks = -(-m // kdgt._CHUNK[dtype])
        tk, tn = kdgt._TILE[dtype]
        tiles = -(-k // tk) * -(-n // tn)
        runs = [(r + 1) * chunks // s - r * chunks // s for r in range(s)]
        assert sum(runs) == chunks and min(runs) >= 1
        assert s * tiles <= kdgt._BLOCKS_PER_SM[dtype] * sms or s == 1


def _constants(name: str) -> dict:
    with open(os.path.join(_CSRC, name)) as f:
        return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", f.read())}


def test_split_parameters_match_the_kernel_source():
    """``dgt.py``'s chunk, tile, blocks an SM and cluster are the constants
    ``dgt.cu`` compiles (f32's tile is qtile's BM x BN)."""
    j, q = _constants("dgt.cu"), _constants("qtile.cuh")
    bf16, f32 = torch.bfloat16, torch.float32
    assert kdgt._CHUNK == {bf16: j["kChunk"], f32: j["kChunkF32"]}
    assert kdgt._TILE == {bf16: (j["kTileK"], j["kTileN"]), f32: (q["BM"], q["BN"])}
    assert kdgt._BLOCKS_PER_SM == {bf16: j["kBlocks"], f32: j["kBlocksF32"]}
    assert kdgt._CLUSTER == {bf16: j["kCluster"], f32: 1}
