"""What bounds the quaternion GEMM's main loop (``csrc/qgemm.cuh``: kernel B,
P = 8, and kernel H, P = 10), on the card: the launcher alone on ready
inputs at the paths' shapes, bf16, whole and with a part of its loop taken
out (the products: the copies and barriers alone; the copies: the products
on stale tiles), and a control whose wgmma descriptor (``qtile.cuh``) has
its two strides swapped, which must fail its parity check. Each version is
kernels B and H built by ``nvcc`` with patched copies of the headers under
``qasr_torch/_build/ablate_qgemm/`` (``tools/_ablate.py``), all builds at
once, and runs in a process of its own; the versions run in turns, first to
last, then back. A whole version is first held against the
plain version at a ragged shape; a version without a part computes wrong
values, and only its time means something. One JSON line a version and
run, and each build's registers and spills.

    python3 -m qasr_torch.tools.ablate_qgemm ["version" ...]
"""

from __future__ import annotations

import json
import sys

import torch

from qasr_torch.ops.kernels.qgemm import qgemm10_cuda, qgemm_stacked_plain
from qasr_torch.ops.kernels.qgemm8 import conj_transpose_dense, qgemm8_cl_plain, qgemm8_cuda
from qasr_torch.ops.quaternion import U8, W_COMBO, combine_weights
from qasr_torch.tools import _ablate

COPIES_ONLY = [("qgemm.cuh", "compute(i % kStages);", "")]
NO_COPIES = [("qgemm.cuh", "    mbar_expect_tx(bar, R::stage);", "    return;"),
             ("qgemm.cuh", "    mbar_wait(bars + 8 * (i % kStages), (i / kStages) & 1);\n", "")]
SWAPPED = [("qtile.cuh", "constexpr unsigned kDescLbo = 1;", "constexpr unsigned kDescLbo = 64;"),
           ("qtile.cuh", "constexpr unsigned kDescSbo = 64;", "constexpr unsigned kDescSbo = 1;")]
# version -> edits (file, old, new), and whether the version still computes
# the GEMM (then its parity is held)
VERSIONS = {
    "whole": ([], True),
    "copies only": (COPIES_ONLY, False),
    "no copies": (NO_COPIES, False),
    "descriptor strides swapped (a control: its parity must fail)": (SWAPPED, True),
}
# the sources each version builds: kernels B and H, and the error strings
SOURCES = ("qgemm8.cu", "qgemm10.cu", "qconv_ft8.cu")
# (kernel, M, K, N) at the paths' shapes: the dense layers of config 2 (B
# forward and dx, H forward and dx), config 4's projection and dense
# layers, and the im2col convs under use_pallas
SHAPES = [
    ("B", 4096, 3328, 256), ("B", 4096, 256, 3328), ("B", 4096, 256, 256),
    ("B", 16384, 512, 256), ("B", 2048, 1664, 2048),
    ("H", 4096, 3328, 256), ("H", 4096, 256, 3328), ("H", 4096, 256, 256),
    ("H", 53248, 2304, 256), ("H", 53248, 256, 2304),
]


def _launcher(kernel):
    return qgemm8_cuda if kernel == "B" else qgemm10_cuda


def run(name: str, path: str, whole: bool) -> None:
    """One version in this process: parity (a whole version) and times."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    lib = _ablate.open_version(path, ("qasr_qgemm8", "qasr_qgemm10"))
    if whole:
        # parity at a ragged shape (M past a cluster's rows, K past a chunk,
        # N past a tile), both roles, against the plain version in f32
        m, k, n = 1000, 200, 136
        w = torch.randn(4, k, n, generator=g, device=dev) * k ** -0.5
        x4 = (torch.randn(4, m, k, generator=g, device=dev) * 0.5).to(torch.bfloat16)
        dy4 = torch.randn(4, m, n, generator=g, device=dev).to(torch.bfloat16)
        for kernel, table, plain in (("B", U8, qgemm8_cl_plain),
                                     ("H", W_COMBO, qgemm_stacked_plain)):
            for role, inp, ww in (("fwd", x4, w), ("dx", dy4, conj_transpose_dense(w))):
                wc = combine_weights(ww, torch.bfloat16, table).contiguous()
                _ablate.check_parity(f"{name} {kernel} {role} M{m} K{k} N{n}",
                                     _launcher(kernel)(inp, wc, lib=lib), plain(inp.float(), ww))
    times = {}
    for kernel, m, k, n in SHAPES:
        table = U8 if kernel == "B" else W_COMBO
        x = (torch.randn(4, m, k, generator=g, device=dev) * 0.5).to(torch.bfloat16)
        wc = combine_weights(torch.randn(4, k, n, generator=g, device=dev) * k ** -0.5,
                             torch.bfloat16, table).contiguous()
        reps = 5 if m * k * n > 2e10 else 20
        times[f"{kernel} M{m} K{k} N{n}"] = round(
            _ablate.time_ms(lambda: _launcher(kernel)(x, wc, lib=lib), reps), 4)
        del x, wc
    print(json.dumps({"version": name, "parity": "ok" if whole else "not held", "ms": times}),
          flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--run":
        run(sys.argv[2], sys.argv[3], VERSIONS[sys.argv[2]][1])
    else:
        _ablate.main("qasr_torch.tools.ablate_qgemm", "ablate_qgemm", VERSIONS, SOURCES,
                     "qgemm_bf16", sys.argv[1:])
