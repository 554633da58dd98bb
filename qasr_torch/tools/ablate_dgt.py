"""What bounds kernel J (``csrc/dgt.cu``, the row-contracting ``x^T y`` of
the probe), on the card: the launcher alone at the probe's shape (M 65536,
K = N = 256, bf16), in both modes, whole and with a part taken out: the
products (the copies and barriers alone), the copies (the products on stale
stages), the second pass that sums the partials, the handover in which a
pair of runs sums its partials in distributed shared memory, and the
second pass's discard of the partials' L2 lines. Each version is kernel J
built by ``nvcc`` with patched copies of the sources under
``qasr_torch/_build/ablate_dgt/`` (``tools/_ablate.py``), all builds at
once, and runs in a process of its own; the versions run in turns, first to
last, then back. A version that still computes ``x^T y`` (whole, no
discard) is first held against the plain version at a ragged shape (M past
a chunk, K and N over partial tiles), both modes giving the same bits; a
version without a part computes wrong values, and only its time means
something. Times are CUDA-graph replays (the host's launch cost out) and
single calls on CUDA events. One JSON line a version and run, and each
build's registers and spills.

    python3 -m qasr_torch.tools.ablate_dgt ["version" ...]
"""

from __future__ import annotations

import json
import sys

import torch

from qasr_torch.ops.kernels.dgt import dgt_cuda, dgt_plain
from qasr_torch.tools import _ablate

SRC = "dgt.cu"
NO_PRODUCTS = [(SRC, "    for (int kk = 0; kk < kChunk / 16; ++kk) {",
                "    for (int kk = 0; kk < 0; ++kk) {")]
NO_COPIES = [(SRC, "    mbar_expect_tx(bar, bytes);", "    return;"),
             (SRC, "    mbar_wait(bars + 8 * st, (i / kStages) & 1);\n", "")]
NO_SECOND_PASS = [(SRC, "  dgt_reduce_kernel<<<(unsigned)((count + kReduceThreads - 1) / "
                        "kReduceThreads), kReduceThreads, 0,\n                      stream>>>("
                        "part, static_cast<__nv_bfloat16*>(out), splits / cluster, count);\n", "")]
NO_HANDOVER = [(SRC, "  if (csize > 1) {\n    const int t = threadIdx.x % 128;",
                "  if (false) {\n    const int t = threadIdx.x % 128;")]
NO_DISCARD = [(SRC, "  if (threadIdx.x % 32 == 0)\n    for (int g = 0; g < groups; ++g)",
               "  if (false)\n    for (int g = 0; g < groups; ++g)")]
# version -> edits (file, old, new), and whether the version still computes
# x^T y (then its parity is held)
VERSIONS = {
    "whole": ([], True),
    "copies only": (NO_PRODUCTS, False),
    "products only": (NO_COPIES, False),
    "no second pass": (NO_SECOND_PASS, False),
    "no handover": (NO_HANDOVER, False),
    "no discard": (NO_DISCARD, True),
}
# the sources each version builds: kernel J, and the error strings
SOURCES = (SRC, "qconv_ft8.cu")
M, K, N = 65536, 256, 256


def run(name: str, path: str, whole: bool) -> None:
    """One version in this process: parity (a version that still computes
    x^T y) and times."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    lib = _ablate.open_version(path, ("qasr_dgt",))
    if whole:
        m, k, n = 1000, 264, 136
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        y = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
        got = dgt_cuda(x, y, mode="dgt", lib=lib)
        if not torch.equal(dgt_cuda(x.T.contiguous(), y, mode="plain", lib=lib), got):
            raise RuntimeError(f"{name}: the two modes differ in bits")
        _ablate.check_parity(f"{name} M{m} K{k} N{n}", got,
                             dgt_plain(x.float(), y.float(), mode="dgt"))
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    y = torch.randn(M, N, generator=g, device=dev).to(torch.bfloat16)
    x_t = x.T.contiguous()
    ms = {}
    for mode, xx in (("dgt", x), ("plain", x_t)):
        ms[f"{mode} graph"] = round(
            _ablate.graph_ms(lambda: dgt_cuda(xx, y, mode=mode, lib=lib), 30), 5)
        ms[f"{mode} call"] = round(
            _ablate.time_ms(lambda: dgt_cuda(xx, y, mode=mode, lib=lib), 50), 5)
    print(json.dumps({"version": name, "parity": "ok" if whole else "not held",
                      "shape": f"M{M} K{K} N{N} bf16", "ms": ms}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--run":
        run(sys.argv[2], sys.argv[3], VERSIONS[sys.argv[2]][1])
    else:
        _ablate.main("qasr_torch.tools.ablate_dgt", "ablate_dgt", VERSIONS, SOURCES,
                     "dgt", sys.argv[1:])
