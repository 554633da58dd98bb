"""What bounds the quaternion GEMM's main loop (``csrc/qgemm.cuh``: kernel B,
P = 8, and kernel H, P = 10), on the card: the launcher alone on ready
inputs at the paths' shapes, bf16, whole and with a part of its loop taken
out (the products: the copies and barriers alone; the copies: the products
on stale tiles), and a control whose wgmma descriptor has its two strides
swapped, which must fail its parity check. Each version is kernels B and H
built by ``nvcc`` with a patched copy of ``qgemm.cuh`` under
``qasr_torch/_build/ablate_qgemm/``, all builds at once, and runs in a
process of its own (one kernel library a process); the versions run in
turns, first to last, then back. A whole version is first held against the
plain version at a ragged shape; a version without a part computes wrong
values, and only its time means something. One JSON line a version and
run, and each build's registers and spills.

    python3 -m qasr_torch.tools.ablate_qgemm ["version" ...]
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from qasr_torch.ops.kernels import _build
from qasr_torch.ops.kernels.qgemm import qgemm10_cuda, qgemm_stacked_plain
from qasr_torch.ops.kernels.qgemm8 import conj_transpose_dense, qgemm8_cl_plain, qgemm8_cuda
from qasr_torch.ops.quaternion import U8, W_COMBO, combine_weights

HEADER = "qgemm.cuh"
COPIES_ONLY = [("compute(i % kStages);", "")]
NO_COPIES = [("    mbar_expect_tx(bar, R::stage);", "    return;"),
             ("    mbar_wait(bars + 8 * (i % kStages), (i / kStages) & 1);\n", "")]
SWAPPED = [("constexpr unsigned kDescLbo = 1;", "constexpr unsigned kDescLbo = 64;"),
           ("constexpr unsigned kDescSbo = 64;", "constexpr unsigned kDescSbo = 1;")]
# version -> edits of qgemm.cuh, and whether the version still computes the
# GEMM (then its parity is held)
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
TOL_BF16 = {"rel_norm": 1e-2, "max_rel": 5e-2}


def _build_version(i: int, edits: list[tuple[str, str]]) -> str:
    """Kernels B and H with ``edits`` made to qgemm.cuh; returns the
    library's path, or "" when it does not build."""
    with open(os.path.join(_build.CSRC, HEADER)) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{HEADER} no longer has {old!r}")
        text = text.replace(old, new)
    out = os.path.join(_build.BUILD_DIR, "ablate_qgemm", str(i))
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, HEADER), "w") as f:
        f.write(text)
    cu = []
    for src in SOURCES:  # beside the patched header, so that its #include finds it
        with open(os.path.join(_build.CSRC, src)) as f:
            body = f.read()
        with open(os.path.join(out, src), "w") as f:
            f.write(body)
        cu.append(os.path.join(out, src))
    lib = os.path.join(out, "libqasr_qgemm.so")
    try:
        log = _build.compile_library(cu, lib)
    except RuntimeError as e:  # a version that does not build is reported and left out
        print(f"version {i} does not build: " + "\n".join(
            line for line in str(e).splitlines() if "error" in line)[:3000], flush=True)
        return ""
    with open(os.path.join(out, "build.log"), "w") as f:
        f.write(log)
    return lib


def _open(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name in ("qasr_qgemm8", "qasr_qgemm10"):
        fn = getattr(lib, name)
        fn.argtypes = _build._ENTRIES[name]
        fn.restype = ctypes.c_int
    lib.qasr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.qasr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def registers(path: str) -> list[str]:
    """ptxas's registers and spills of the bf16 GEMM kernels in a build."""
    with open(os.path.join(os.path.dirname(path), "build.log")) as f:
        log = f.read()
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        if kernel and "qgemm_bf16" in kernel and ("Used" in line or "spill" in line):
            out.append(f"{kernel}: {line.strip()}")
    return out


def _time_ms(fn, n: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _launcher(kernel):
    return qgemm8_cuda if kernel == "B" else qgemm10_cuda


def run(name: str, path: str, whole: bool) -> None:
    """One version in this process: parity (a whole version) and times."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    lib = _open(path)
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
                got = _launcher(kernel)(inp, wc, lib=lib).float()
                ref = plain(inp.float(), ww)
                rel = ((got - ref).norm() / ref.norm()).item()
                mx = ((got - ref).abs().max() / ref.abs().max()).item()
                if not (rel <= TOL_BF16["rel_norm"] and mx <= TOL_BF16["max_rel"]):
                    raise RuntimeError(f"{name} {kernel} {role} M{m} K{k} N{n}: rel_norm "
                                       f"{rel:.3e} max_rel {mx:.3e} exceed {TOL_BF16}")
    times = {}
    for kernel, m, k, n in SHAPES:
        table = U8 if kernel == "B" else W_COMBO
        x = (torch.randn(4, m, k, generator=g, device=dev) * 0.5).to(torch.bfloat16)
        wc = combine_weights(torch.randn(4, k, n, generator=g, device=dev) * k ** -0.5,
                             torch.bfloat16, table).contiguous()
        reps = 5 if m * k * n > 2e10 else 20
        times[f"{kernel} M{m} K{k} N{n}"] = round(
            _time_ms(lambda: _launcher(kernel)(x, wc, lib=lib), reps), 4)
        del x, wc
    print(json.dumps({"version": name, "parity": "ok" if whole else "not held", "ms": times}),
          flush=True)


def main(names: list[str]) -> None:
    """Every version, or those named."""
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_qgemm needs a CUDA device")
    names = names or list(VERSIONS)
    unknown = [n for n in names if n not in VERSIONS]
    if unknown:
        raise ValueError(f"unknown versions {unknown}; known: {list(VERSIONS)}")
    print(torch.cuda.get_device_name(0), flush=True)
    with ThreadPoolExecutor(len(names)) as pool:  # every version's nvcc runs at once
        paths = dict(zip(names, pool.map(_build_version, range(len(names)),
                                         [VERSIONS[n][0] for n in names])))
    names = [n for n in names if paths[n]]
    for name in names:
        print(f"{name}: " + "; ".join(registers(paths[name])), flush=True)
    for name in names + names[::-1]:
        proc = subprocess.run([sys.executable, "-m", "qasr_torch.tools.ablate_qgemm", "--run",
                               name, paths[name]], capture_output=True, text=True)
        print(proc.stdout.strip() or f"{name}: rc {proc.returncode} {proc.stderr[-800:]}",
              flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--run":
        run(sys.argv[2], sys.argv[3], VERSIONS[sys.argv[2]][1])
    else:
        main(sys.argv[1:])
