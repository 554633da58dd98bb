"""The row-contracting product ``out [K, N] = x^T y``: kernel J
(``qasr_torch/csrc/dgt.cu``) and its plain PyTorch version.

Counterpart of the TPU kernel ``benchmarks/probe_dgt.py:kern``, which asks
whether a matrix unit contracts rows with rows (the orientation a weight
gradient needs) as fast as the native orientation. Two modes, as the probe's:

- ``"dgt"``: ``x [M, K]``, rows contract with rows: ``out = x^T y``;
- ``"plain"``: ``x`` pre-transposed to ``[K, M]``: ``out = x y``.

``y`` is ``[M, N]`` in both; bf16 or f32 in, f32 accumulation, one cast to
x's dtype at the end. Kernel J splits M over blocks and sums the f32
partials in a second pass in fixed order, so it gives the same bits every
run, and the two modes give the same bits as each other.
"""

from __future__ import annotations

import math

import torch

from qasr_torch.ops.kernels import _build
from qasr_torch.ops.kernels.qconv_ft import _DTYPE_CODE, _check_cuda_tensor

MODES = ("dgt", "plain")
# kernel J's rows of M a chunk, its (K, N) output tile and its blocks
# resident on an SM (dgt.cu: kChunk, kTileK, kTileN, kBlocks for bf16's
# wgmma loop; kChunkF32, qtile's BM x BN and kBlocksF32 for f32's): the
# split of M fills at most one wave of them
_CHUNK = {torch.bfloat16: 64, torch.float32: 16}
_TILE = {torch.bfloat16: (128, 256), torch.float32: (64, 64)}
_BLOCKS_PER_SM = {torch.bfloat16: 1, torch.float32: 4}
# the bf16 loop pairs runs in a cluster and sums their partials in shared
# memory before the second pass (dgt.cu: kCluster)
_CLUSTER = {torch.bfloat16: 2, torch.float32: 1}


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (choose {' | '.join(MODES)})")


def _dims(x: torch.Tensor, y: torch.Tensor, mode: str) -> tuple[int, int, int]:
    """``(M, K, N)`` of ``x`` and ``y`` in ``mode``; raises on shapes that do
    not contract."""
    _check_mode(mode)
    if x.ndim != 2 or y.ndim != 2:
        raise ValueError(f"expected 2-D x and y, got {tuple(x.shape)} and {tuple(y.shape)}")
    m, k = x.shape if mode == "dgt" else x.shape[::-1]
    if y.shape[0] != m:
        raise ValueError(f"x {tuple(x.shape)} ({mode}) and y {tuple(y.shape)} do not contract")
    return m, k, y.shape[1]


def dgt_plain(x: torch.Tensor, y: torch.Tensor, *, mode: str) -> torch.Tensor:
    """Plain version of kernel J: ``x.float().T @ y.float()`` (``"dgt"``) or
    ``x.float() @ y.float()`` (``"plain"``), cast to x's dtype."""
    _dims(x, y, mode)
    xf = x.float()
    return ((xf.T if mode == "dgt" else xf) @ y.float()).to(x.dtype)


def supported(m: int, k: int, n: int, dtype: torch.dtype, mode: str = "dgt") -> bool:
    """Whether kernel J takes these shapes: f32 or bf16, K and N multiples of
    8 (16-byte rows), and M too in ``"plain"`` mode, where x's rows run
    along M."""
    _check_mode(mode)
    return (
        dtype in _DTYPE_CODE and m >= 1 and k >= 1 and n >= 1 and k % 8 == 0 and n % 8 == 0
        and (mode == "dgt" or m % 8 == 0)
    )


def splits(m: int, k: int, n: int, *, chunk: int, tile: tuple[int, int], blocks_per_sm: int,
           sms: int) -> int:
    """The number of runs S of M that kernel I (``qgemm.py``) sums apart, its
    grid ``(N/tile_n, K/tile_k, S)`` with ``blocks_per_sm`` blocks resident
    on each of ``sms`` SMs: the whole number of runs nearest one full wave,
    at least 1 (so S = 1 where the tiles alone fill a wave), each run whole
    chunks of ``chunk`` rows and none empty. (Kernel J's rule is
    :func:`j_splits`.)"""
    chunks = math.ceil(m / chunk)
    tiles = math.ceil(k / tile[0]) * math.ceil(n / tile[1])
    slots = blocks_per_sm * sms
    want = min(chunks, max(1, (2 * slots + tiles) // (2 * tiles)))
    return math.ceil(chunks / math.ceil(chunks / want))


def j_splits(m: int, k: int, n: int, dtype: torch.dtype, sms: int) -> int:
    """Kernel J's runs S of M on ``sms`` SMs: as many as its grid ``(N
    tiles, K tiles, S)`` fits in one wave of its blocks (never a second,
    partial one), at most one a chunk, and a multiple of the cluster where
    there are that many. The kernel shares the chunks out as evenly as whole
    chunks allow, so no run is empty."""
    chunks = math.ceil(m / _CHUNK[dtype])
    tiles = math.ceil(k / _TILE[dtype][0]) * math.ceil(n / _TILE[dtype][1])
    s = max(1, min(chunks, _BLOCKS_PER_SM[dtype] * sms // tiles))
    return s - s % _CLUSTER[dtype] if s >= _CLUSTER[dtype] else s


def partials(s: int, dtype: torch.dtype) -> int:
    """The f32 partials kernel J's second pass sums for S runs: one a
    cluster, which pairs the runs in bf16 where S is even (dgt.cu:
    cluster_of)."""
    c = _CLUSTER[dtype]
    return s // c if s % c == 0 else s


def dgt_cuda(x: torch.Tensor, y: torch.Tensor, *, mode: str, lib=None) -> torch.Tensor:
    """Launch kernel J (its two passes) on CUDA ``x`` and ``y``: one device,
    contiguous, the same dtype, shapes :func:`supported` admits. Returns
    ``[K, N]`` in x's dtype. ``lib`` is a kernel library other than the
    package's (a variant built by ``qasr_torch.tools.ablate_dgt``). Raises on
    anything the kernel does not take, or when it fails to build or
    launch."""
    m, k, n = _dims(x, y, mode)
    if not supported(m, k, n, x.dtype, mode):
        raise ValueError(f"kernel J does not take M={m} K={k} N={n} {x.dtype} ({mode})")
    _check_cuda_tensor("x", x, x.dtype, x.shape)
    _check_cuda_tensor("y", y, x.dtype, y.shape)
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")
    lib = lib if lib is not None else _build.load_library()
    s = j_splits(m, k, n, x.dtype, torch.cuda.get_device_properties(x.device).multi_processor_count)
    part = torch.empty((partials(s, x.dtype), k, n), dtype=torch.float32, device=x.device)
    out = torch.empty((k, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qasr_dgt(
            x.data_ptr(), y.data_ptr(), part.data_ptr(), out.data_ptr(), m, k, n, s,
            int(mode == "dgt"), _DTYPE_CODE[x.dtype], stream,
        )
    _build.check(lib, err, "dgt launch")
    dgt.launches += 1
    return out


def dgt(x: torch.Tensor, y: torch.Tensor, *, mode: str, plain: bool = False) -> torch.Tensor:
    """``out [K, N]`` of ``x`` and ``y [M, N]`` in ``mode`` (see the module
    docstring), in x's dtype. A CPU tensor, or ``plain=True``, takes the
    plain version; a CUDA tensor launches kernel J (counted in
    ``dgt.launches``) or raises."""
    if plain or not x.is_cuda:
        return dgt_plain(x, y, mode=mode)
    return dgt_cuda(x, y, mode=mode)


#: launches of kernel J since the last reset (counted where it launches)
dgt.launches = 0
